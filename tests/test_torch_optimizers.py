"""The port's LAMB, Lion, Adagrad and SGD against the JAX package's, and
their state through a checkpoint (CPU).

Tolerances, each with its reason:
- optimizer steps: rtol 1e-6 over 5 steps of a seeded f32 tree, each
  element against 1e-6 of its own value plus 1e-6 of its leaf's largest
  (the same elementwise chain in the same order; LAMB's per-tensor norms
  and its global-norm clip are sums in other orders, and f32 pow / sqrt may
  differ in the last ulp, so a moment that cancels to near zero keeps an
  error of the leaf's scale, not its own);
- resume within the port: bit for bit (the same ops on the same values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.ops import build_optimizer as jax_build_optimizer
from deepspeed_tpu.ops.adagrad import Adagrad as JaxAdagrad
from deepspeed_tpu.ops.lamb import FusedLamb as JaxLamb
from deepspeed_tpu.ops.lion import FusedLion as JaxLion
from deepspeed_tpu.ops.sgd import SGD as JaxSGD
from deepspeed_tpu.utils.tree import clip_by_global_norm as jax_clip
from deepspeed_tpu_torch.checkpoint.state import flatten_tree
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.ops import (OPTIMIZER_REGISTRY, SGD, Adagrad, FusedLamb, FusedLion,
                                     build_optimizer)
from deepspeed_tpu_torch.utils.tree import clip_by_global_norm

from tests._torch_threads import one_torch_thread  # noqa: F401

SHAPES = {"w": (6, 5), "b": (5,), "e": (9, 3), "z": (4,)}

# name -> (port class, JAX class, keyword arguments)
CASES = {
    "lamb": (FusedLamb, JaxLamb, dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8,
                                      weight_decay=0.01)),
    "lamb-clip": (FusedLamb, JaxLamb, dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-6,
                                           max_grad_norm=1.0)),
    "lamb-nobc-clamp": (FusedLamb, JaxLamb, dict(lr=5e-3, bias_correction=False,
                                                 max_coeff=0.5, min_coeff=0.1)),
    "lion": (FusedLion, JaxLion, dict(lr=1e-3, betas=(0.9, 0.99), weight_decay=0.1)),
    "lion-nowd": (FusedLion, JaxLion, dict(lr=1e-3)),
    "adagrad": (Adagrad, JaxAdagrad, dict(lr=1e-2, eps=1e-10)),
    "adagrad-wd": (Adagrad, JaxAdagrad, dict(lr=1e-2, weight_decay=0.05)),
    "sgd": (SGD, JaxSGD, dict(lr=1e-2)),
    "sgd-wd": (SGD, JaxSGD, dict(lr=1e-2, weight_decay=0.01)),
    "sgd-momentum": (SGD, JaxSGD, dict(lr=1e-2, momentum=0.9)),
    "sgd-nesterov": (SGD, JaxSGD, dict(lr=1e-2, momentum=0.9, nesterov=True,
                                       weight_decay=0.01)),
}


def _tree(rng, scale=1.0):
    tree = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    tree["z"][:] = 0.0     # a zero leaf: LAMB's trust ratio falls back to 1
    return tree


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_jax_over_5_steps(name):
    cls, jcls, kw = CASES[name]
    port, ref = cls(**kw), jcls(**kw)
    rng = np.random.default_rng(len(name))
    params = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = ref.init(jp), port.init(pp)
    assert set(ps) == set(js)
    for step in range(5):
        g = _tree(rng, scale=2.0 if "clip" in name else 0.5)
        lr = kw["lr"] * (step + 1) / 5
        jp, js = ref.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                            lr=jnp.float32(lr))
        pp, ps = port.update({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp,
                             lr=torch.tensor(lr, dtype=torch.float32))
    assert int(ps["step"]) == int(js["step"]) == 5

    def close(got, want, msg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=msg)

    for k in SHAPES:
        close(pp[k], jp[k], k)
        for slot in set(ps) - {"step"}:
            close(ps[slot][k], js[slot][k], f"{slot}/{k}")


def test_update_leaves_its_inputs_unchanged():
    """``update`` returns new tensors: the engine keeps the old master and
    state where the fp16 scaler saw an overflow."""
    rng = np.random.default_rng(1)
    params = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    grads = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    for cls, _, kw in CASES.values():
        opt = cls(**kw)
        state = opt.update(grads, opt.init(params), params)[1]
        before = [{k: t.clone() for k, t in tree.items()} for tree in (params, grads)]
        slots = {key: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v.clone())
                 for key, v in state.items()}
        opt.update(grads, state, params)
        for old, tree in zip(before, (params, grads)):
            assert all(torch.equal(old[k], tree[k]) for k in tree), cls.__name__
        for key, v in slots.items():
            if isinstance(v, dict):
                assert all(torch.equal(v[n], state[key][n]) for n in v), (cls.__name__, key)
            else:
                assert torch.equal(v, state[key]), (cls.__name__, key)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    tree = _tree(rng, scale=3.0)
    got, norm = clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()}, 1.0)
    want, jnorm = jax_clip({k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("opt_type, params", [
    ("Lamb", {"lr": "1e-3", "betas": ["0.9", "0.98"], "eps": "1e-6", "weight_decay": "0.01",
              "max_grad_norm": 1.0}),
    ("FusedLamb", {"lr": 2e-3}),
    ("lion", {"lr": "1e-4", "betas": [0.95, 0.98], "weight_decay": "0.1"}),
    ("Fused_Lion", {}),
    ("Adagrad", {"lr": "1e-2", "eps": "1e-10"}),
    ("SGD", {"lr": "0.1", "momentum": 0.9, "nesterov": True}),
])
def test_registry_names_and_string_params_match_jax(opt_type, params):
    port = build_optimizer(opt_type, params)
    ref = jax_build_optimizer(opt_type, params)
    assert type(port).__name__ == type(ref).__name__
    for attr in ("lr", "betas", "eps", "weight_decay", "max_grad_norm", "momentum",
                 "nesterov", "bias_correction", "max_coeff", "min_coeff"):
        assert getattr(port, attr, None) == getattr(ref, attr, None), attr


def test_registry_covers_the_jax_device_optimizers():
    # the host-offloaded names are registered since the offload tier was
    # ported; only the 1-bit optimizers stay out
    from deepspeed_tpu.ops import OPTIMIZER_REGISTRY as JAX_REGISTRY
    onebit = {"onebitadam", "onebitlamb", "zerooneadam"}
    assert set(OPTIMIZER_REGISTRY) == set(JAX_REGISTRY) - onebit


@pytest.mark.parametrize("name", ["cpulion", "onebitlamb", "CPUAdagrad"])
def test_host_and_onebit_optimizers_raise_by_name(name):
    # the host-offloaded optimizers build as the JAX package's classes (the
    # offload tier steps them on the host); the 1-bit ones raise by name
    if name.lower().startswith("onebit"):
        with pytest.raises(NotImplementedError, match=name):
            build_optimizer(name, {"lr": 1e-3})
        return
    port = build_optimizer(name, {"lr": 1e-3})
    assert type(port).__name__ == type(jax_build_optimizer(name, {"lr": 1e-3})).__name__
    assert port.host_offload and port.lr == 1e-3


# --------------------------------------------------------------------------- #
# resume through a checkpoint
# --------------------------------------------------------------------------- #

RESUME = {
    "Lamb": {"lr": 1e-3, "weight_decay": 0.01, "max_grad_norm": 1.0},
    "Lion": {"lr": 1e-4, "weight_decay": 0.1},
    "Adagrad": {"lr": 1e-2},
    "SGD": {"lr": 1e-2, "momentum": 0.9},
}


def _engine(opt_type, seed):
    cfg = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "steps_per_print": 0,
           "gradient_clipping": 1.0,
           "optimizer": {"type": opt_type, "params": RESUME[opt_type]},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_min_lr": 0, "warmup_max_lr": RESUME[opt_type]["lr"],
               "warmup_num_steps": 4}}}
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=seed)
    return deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")[0]


def _state(engine):
    st = engine.state
    return {k: v.clone() for k, v in flatten_tree(
        {"master": st["master"], "opt": st["opt"], "step": st["step"]}).items()}


@pytest.mark.parametrize("opt_type", sorted(RESUME))
def test_optimizer_state_resumes_bit_for_bit(opt_type, tmp_path):
    rng = np.random.default_rng(3)
    batches = [{"input_ids": rng.integers(0, 256, (4, 16)).astype(np.int32)} for _ in range(6)]
    a = _engine(opt_type, seed=0)
    a.train_steps(3, data_iter=iter(batches[:3]))
    a.save_checkpoint(str(tmp_path))
    tail = a.train_steps(3, data_iter=iter(batches[3:]))
    want = _state(a)
    a.destroy()
    b = _engine(opt_type, seed=1)
    b.load_checkpoint(str(tmp_path), verify=True)
    got_tail = b.train_steps(3, data_iter=iter(batches[3:]))
    got = _state(b)
    b.destroy()
    assert got_tail.tobytes() == tail.tobytes()
    assert set(got) == set(want) and any(k.startswith("opt/") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
