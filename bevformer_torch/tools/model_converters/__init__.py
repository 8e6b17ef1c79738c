"""The JAX package's `tools/model_converters/`: `publish_model`
(`python3 -m bevformer_torch.tools.model_converters.publish_model`)."""
