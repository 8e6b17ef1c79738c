"""The mixed-precision training CLI, `python3 -m bevformer_torch.tools.fp16.train`."""
