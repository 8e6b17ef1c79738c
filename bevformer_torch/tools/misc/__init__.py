"""The JAX package's `tools/misc/` on the port: `print_config`,
`fuse_conv_bn`, `browse_dataset`, `visualize_results`
(`python3 -m bevformer_torch.tools.misc.<name>`, each with `main(argv)`)."""
