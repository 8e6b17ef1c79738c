"""The port's CLIs and its kernel benchmark and probe tools.

The CLIs are the JAX package's `tools/create_data.py synth`,
`tools/train.py` and `tools/test.py` (v1): `python3 -m
bevformer_torch.tools.<create_data|train|test>`, each with a `main(argv)`;
train and test run on the card unless given `--device cpu`.

The kernel tools are each the counterpart of the
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

The model measuring tools are the JAX package's tools of the same names,
each a `main(argv) -> dict` that raises without a card and prints one JSON
line (`common.json_line`): `benchmark` (frames/s of video inference, in
`bench.py`'s shape), `bench_train_step`, `bench_v2`, `bench_train_v2`,
`bench_components`, `bench_enc_only`, `bench_dcn`, `bench_train2`,
`bench_train_bisect` and `audit_sca_capacity`.
"""
