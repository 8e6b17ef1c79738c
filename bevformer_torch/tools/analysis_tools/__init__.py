"""The JAX package's `tools/analysis_tools/` on the port: `get_params`,
`analyze_logs`, `visual` (`python3 -m
bevformer_torch.tools.analysis_tools.<name>`, each with `main(argv)`)."""
