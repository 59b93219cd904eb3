"""K2's lse output and the head dims 80 and 96, and the engine's
``compile`` section, held against the JAX package on the CPU.

The plain packed-prefill attention (``flash_attention_packed_plain``) with
``with_lse=True`` against the Pallas kernel's ``flash_attention_packed(...,
with_lse=True)`` in interpret mode, as the JAX package's own tests run it:
o and lse on the segments' rows (padding rows are never read), with and
without a window, at D = 16 and 80. Inputs are made with numpy from a seed;
both sides compute in f32 and agree to 2e-5 (the same f32 products summed
in another order). The wrapper on CPU tensors returns ``(o, lse)`` only
when asked. The ``compile`` section of both packages' engine configs
refuses the same values with the same message and normalises
``warmup_buckets`` to the same pow2 grid."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_packed as jax_packed
from deepspeed_tpu_torch.inference.v2.config_v2 import (
    RaggedInferenceEngineConfig as TorchConfig)
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed, flash_attention_packed_plain
from deepspeed_tpu_torch.ops.kernels._loader import CSRC
from deepspeed_tpu_torch.ops.kernels.flash_packed import KERNEL_HEAD_DIMS

from tests._torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5
R, H, HKV, N_SEG_ROWS = 100, 4, 2, 95


def _inputs(D, seed):
    """GQA 4/2, R = 100 rows: segments of 40, 31 and 24 rows, then 5
    padding rows (segment -1)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(R, H, D).astype(np.float32)
    k = rng.randn(R, HKV, D).astype(np.float32)
    v = rng.randn(R, HKV, D).astype(np.float32)
    seg = np.full((R,), -1, np.int32)
    seg[:40], seg[40:71], seg[71:N_SEG_ROWS] = 0, 1, 2
    return q, k, v, seg


@pytest.mark.parametrize("D, window", [(16, None), (16, 7), (80, None), (80, 7)])
def test_packed_lse_matches_k2(D, window):
    q, k, v, seg = _inputs(D, D + (window or 0))
    ref_o, ref_lse = jax_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(seg), with_lse=True, window=window)
    o, lse = flash_attention_packed_plain(*(torch.from_numpy(a) for a in (q, k, v, seg)),
                                          window=window, with_lse=True)
    assert lse.shape == (R, H) and lse.dtype == torch.float32
    rows = slice(0, N_SEG_ROWS)
    np.testing.assert_allclose(o[rows].numpy(), np.asarray(ref_o)[rows], rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse[rows].numpy(), np.asarray(ref_lse)[rows], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 7])
def test_wrapper_returns_lse_only_when_asked(dtype, window):
    """On CPU tensors ``with_lse=True`` gives (o [R, H, D] in q's dtype,
    lse [R, H] f32), the default gives o alone, the same o."""
    q, k, v, seg = (torch.from_numpy(a) for a in _inputs(80, 3))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    o, lse = flash_attention_packed(q, k, v, seg, window=window, with_lse=True)
    o_only = flash_attention_packed(q, k, v, seg, window=window)
    assert o.shape == (R, H, 80) and o.dtype == dtype
    assert lse.shape == (R, H) and lse.dtype == torch.float32
    assert isinstance(o_only, torch.Tensor) and torch.equal(o_only, o)
    assert torch.isfinite(lse).all()


def _dispatch_dims(path, macro):
    body = re.search(rf"#define {macro}\(.*?default:", (CSRC / path).read_text(), re.S)
    return tuple(int(d) for d in re.findall(r"case (\d+):", body.group(0)))


def test_head_dims_match_the_c_dispatch():
    """K2's wrapper admits exactly the head dims its C switch builds, and
    K5's bf16 switch builds phi-2's D = 80 and GPT-NeoX-20B's D = 96."""
    assert _dispatch_dims("flash_packed.cu", "DSTORCH_PACKED_DISPATCH_D") == KERNEL_HEAD_DIMS
    assert {80, 96} <= set(_dispatch_dims("attn_common.cuh", "DSTORCH_DISPATCH_D"))


BAD_COMPILE = {
    "bucket 0": {"warmup_buckets": [0]},
    "bucket -1": {"warmup_buckets": [-1]},
    "bucket str": {"warmup_buckets": ["a"]},
    "steps 0": {"warmup_decode_steps": [0]},
    "steps -1": {"warmup_decode_steps": [-1]},
    "steps str": {"warmup_decode_steps": ["a"]},
}


@pytest.mark.parametrize("case", sorted(BAD_COMPILE))
def test_compile_section_refuses_what_jax_refuses(case):
    messages = []
    for config in (JaxConfig, TorchConfig):
        with pytest.raises(ValueError) as exc:
            config.load({"compile": BAD_COMPILE[case]})
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_compile_section_normalises_like_jax():
    section = {"warmup_buckets": [3, 8], "warmup_decode_steps": [4]}
    jax_cfg, torch_cfg = (c.load({"compile": section}).compile
                          for c in (JaxConfig, TorchConfig))
    assert jax_cfg.warmup_buckets == torch_cfg.warmup_buckets == [4, 8]
    assert list(jax_cfg.warmup_decode_steps) == list(torch_cfg.warmup_decode_steps) == [4]
