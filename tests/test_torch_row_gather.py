"""The port's row gather (`bevformer_torch/kernels/gather.py::row_gather`) on
the CPU, against `jnp.take_along_axis(src, idx[:, :, None], axis=1)`, the
function the JAX package's DMA-gather probe holds its kernel to: bitwise, in
bf16 and fp32. The CUDA kernel is held to the same on the card
(`tests/test_torch_kernels.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_torch.kernels import gather

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,m,r,e,permute", [
    (6, 64, 64, 256, True),  # the probe's case at 1/640 of its rows
    (3, 50, 20, 16, False),  # fewer rows out than in, repeats
])
def test_row_gather_matches_jax_take_along_axis_bitwise(dtype, b, m, r, e, permute):
    rng = np.random.RandomState(e)
    src = rng.randn(b, m, e).astype(np.float32)
    if permute:
        idx = np.stack([rng.permutation(m) for _ in range(b)]).astype(np.int32)
    else:
        idx = rng.randint(0, m, (b, r)).astype(np.int32)
    tdt, jdt = DTYPES[dtype]
    ref = jnp.take_along_axis(jnp.asarray(src, jdt), jnp.asarray(idx)[:, :, None], axis=1)
    ref = np.asarray(ref.astype(jnp.float32)).astype(np.float32)
    before = gather.row_gather.launches
    ours = gather.row_gather(torch.from_numpy(src).to(tdt), torch.from_numpy(idx))
    assert gather.row_gather.launches == before  # the plain version ran
    assert ours.dtype == tdt and tuple(ours.shape) == (b, r, e)
    np.testing.assert_array_equal(_bits(ours.float().numpy()), _bits(ref))


def test_row_gather_refuses_what_the_kernel_cannot_take():
    src = torch.zeros((2, 8, 16), dtype=torch.float32)
    idx = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        gather.row_gather(src, idx.long())  # int32 indices only
    with pytest.raises(TypeError):
        gather.row_gather(src.half(), idx)  # bf16 or fp32 rows
    with pytest.raises(ValueError):
        gather.row_gather(src[:, :, :3].contiguous(), idx)  # 12-byte rows
    with pytest.raises(ValueError):
        gather.row_gather(src.transpose(1, 2), idx[:, :2])  # not contiguous
    with pytest.raises(IndexError):
        gather.row_gather(src, idx + 8)  # out of range, caught on the CPU
