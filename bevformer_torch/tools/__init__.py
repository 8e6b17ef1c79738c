"""The port's kernel benchmark and probe tools, each the counterpart of the
JAX package's tool of the same name under `tools/`, at bevformer_base's
full SCA width. Each runs on a CUDA card as

    python -m bevformer_torch.tools.<name> [cases] [options]

and has a `main(argv) -> list[dict]` that prints one JSON line per measured
case: `bench_msda_kernel` (K7 and K1 against the plain msda),
`bench_kernel_probe3` (K7's tile and accumulator sweep), `bench_kernel_probe`
and `bench_hi_probe` (the cost split of K7 and of K1),
`bench_msda_decompose` (both kernels at SCA's level 0 alone) and
`bench_dma_gather` (the row gather against `torch.take_along_dim`).
`roofline` gives each kernel call's least time on the card from its shapes;
`common` holds the shapes, seeded inputs and CUDA-event timing.
"""
