"""The port's training slice against the JAX package, on the same weights
and batches (CPU; the port runs its kernels' plain versions, the JAX package
its dense attention path).

Tolerances, each with its reason:
- GPT-2 loss rtol 1e-5 / atol 1e-6, fp32 logits atol 1e-5, gradients rtol
  1e-4 / atol 1e-6: f32 on both sides, the same products summed in other
  orders through two layers and a softmax over the vocabulary.
- Config, lr schedules, the loss scaler: exact or rtol 1e-6 (one f32 op
  chain on each side; pow/log1p may differ in the last ulp).
- FusedAdam: rtol 1e-6 on the master after 3 steps (the same op order; the
  f32 pow of the bias corrections may differ in the last ulp).
- Engine, fp32: rtol 1e-4 over 20 steps of loss and grad norm (per-step
  f32 differences of ~1e-7 compound through AdamW).
- Engine, bf16: rtol 2e-2 over 5 steps (bf16 has 8 bits of mantissa, 2^-8
  = 0.4%, and the two frameworks round at different places).
- Within the port: ``train_steps(n)`` equals n ``train_batch`` calls byte
  for byte (the same ops in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.comm.mesh import build_topology
from deepspeed_tpu.config import ConfigError as JaxConfigError
from deepspeed_tpu.config import DeepSpeedTPUConfig as JaxConfig
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.ops.adam import FusedAdam as JaxAdam
from deepspeed_tpu.runtime import loss_scaler as jax_scaler
from deepspeed_tpu.runtime.lr_schedules import build_lr_schedule as jax_schedule
from deepspeed_tpu.utils.tree import global_norm as jax_global_norm
from deepspeed_tpu_torch.checkpoint import params_from_flat, params_to_flat
from deepspeed_tpu_torch.config import ConfigError, DeepSpeedTPUConfig
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.ops import build_optimizer
from deepspeed_tpu_torch.ops.adam import FusedAdam
from deepspeed_tpu_torch.runtime import loss_scaler
from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_schedule
from deepspeed_tpu_torch.utils.tree import global_norm, tree_cast

from tests._torch_threads import one_torch_thread  # noqa: F401

# name -> (GPT2Config overrides, batch rows, T)
GPT2_CASES = {
    "tiny-D16": (dict(), 2, 32),
    # head_dim 64 at T = 128; one chunk of rows per sample -> two loss chunks
    "T128-D64": (dict(n_embd=128, n_head=2, lm_loss_chunk=1), 2, 128),
}


def _flax_gpt2(name, dtype=jnp.float32):
    kw, B, T = GPT2_CASES[name]
    model = JaxGPT2(JaxGPT2Config.tiny(dtype=dtype, **kw))
    ids = np.random.RandomState(len(name)).randint(0, 256, (B, T)).astype(np.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), {"input_ids": jnp.asarray(ids)})
    return model, params["params"], ids


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _port_gpt2(name, flat, dtype=torch.float32):
    kw, _, _ = GPT2_CASES[name]
    model = GPT2LMHead(GPT2Config.tiny(dtype=dtype, **kw), device="cpu", seed=1)
    model.load_flat_params(params_from_flat(flat, device="cpu"))
    return model


# --------------------------------------------------------------------------- #
# GPT-2
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gpt2_weight_carrier_round_trip_is_byte_equal(dtype):
    _, params, _ = _flax_gpt2("tiny-D16")
    flat = {k: v.astype(dtype) for k, v in _flat(params).items()}
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32 if dtype == jnp.float32
                                       else torch.bfloat16), device="cpu")
    model.load_flat_params(params_from_flat(flat, device="cpu"))
    back = params_to_flat(model.flat_params())
    assert set(back) == set(flat)
    for k, a in flat.items():
        assert back[k].dtype == a.dtype and back[k].tobytes() == a.tobytes(), k


@pytest.mark.parametrize("name", sorted(GPT2_CASES))
def test_gpt2_loss_logits_and_grads_match_flax(name):
    model, params, ids = _flax_gpt2(name)
    batch = {"input_ids": jnp.asarray(ids)}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply({"params": p}, batch)))(params)
    ref_logits = jax.jit(model.apply)({"params": params}, jnp.asarray(ids))
    port = _port_gpt2(name, _flat(params))
    loss = port({"input_ids": torch.from_numpy(ids)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5, atol=1e-6)
    logits = port(torch.from_numpy(ids)).detach()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=0, atol=1e-5)
    ref = _flat(ref_grads)
    grads = port.named_flat_parameters()
    assert set(grads) == set(ref)
    for n, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[n], rtol=1e-4, atol=1e-6, err_msg=n)


def test_gpt2_unported_options_raise():
    for kw, feature in [({"remat": True}, "remat"),
                        ({"sequence_parallel": True}, "sequence_parallel")]:
        with pytest.raises(NotImplementedError, match=feature):
            GPT2Config.tiny(**kw)
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu")
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="pld_theta"):
        model({"input_ids": ids, "pld_theta": torch.ones(1)})


# --------------------------------------------------------------------------- #
# pieces: config, lr schedules, loss scaler, optimizer, tree helpers
# --------------------------------------------------------------------------- #

CONFIG_DICTS = [
    {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 8},
    {"train_batch_size": 16, "gradient_accumulation_steps": 4},
    {"train_micro_batch_size_per_gpu": 3},
    {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 5},
    {"train_batch_size": 7},
    {"train_batch_size": "1.6e1", "train_micro_batch_size_per_gpu": 4.0},
    {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
     "gradient_accumulation_steps": 2, "bf16": {"enabled": True},
     "zero_optimization": {"stage": 3}, "gradient_clipping": "1e0"},
    # bad: inconsistent triple, not divisible, nothing set, stage 4,
    # bf16 + fp16, a bool for an int
    {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
     "gradient_accumulation_steps": 4},
    {"train_batch_size": 10, "train_micro_batch_size_per_gpu": 4},
    {},
    {"train_batch_size": 8, "zero_optimization": {"stage": 4}},
    {"train_batch_size": 8, "bf16": {"enabled": True}, "fp16": {"enabled": True}},
    {"train_batch_size": True},
]


@pytest.mark.parametrize("i", range(len(CONFIG_DICTS)))
def test_config_resolves_and_refuses_like_jax(i):
    d = CONFIG_DICTS[i]
    try:
        want = JaxConfig.load(d).resolve_batch(1)
    except JaxConfigError:
        with pytest.raises(ConfigError):
            DeepSpeedTPUConfig.load(d).resolve_batch(1)
        return
    cfg = DeepSpeedTPUConfig.load(d)
    assert cfg.resolve_batch(1) == want
    jcfg = JaxConfig.load(d)
    assert cfg.compute_dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
                                 jnp.float16: torch.float16}[jcfg.compute_dtype]
    assert cfg.gradient_clipping == jcfg.gradient_clipping
    assert cfg.zero_optimization.stage == jcfg.zero_optimization.stage


SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 0.0, "warmup_max_lr": 6e-4, "warmup_num_steps": 5}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 20,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 40, "warmup_max_lr": 1e-3,
                       "warmup_num_steps": 10}),
    ("WarmupCosineLR", {"total_num_steps": 45, "warmup_num_steps": 7, "lr": 3e-4,
                        "warmup_min_ratio": 0.1}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 10,
                  "decay_lr_rate": 0.5, "decay_step_size": 4}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 6,
                     "lr_range_test_step_rate": 2.0, "lr_range_test_staircase": True}),
    (None, {}),
]


@pytest.mark.parametrize("i", range(len(SCHEDULES)))
def test_lr_schedule_matches_jax(i):
    kind, params = SCHEDULES[i]
    ref = jax_schedule(kind, params, 5e-4)
    port = build_lr_schedule(kind, params, 5e-4)
    for s in range(51):
        want = float(ref(jnp.int32(s)))
        got = port(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0, err_msg=f"step {s}")


def test_loss_scaler_matches_jax_over_an_overflow_pattern():
    pattern = [False, True, True, False, False, False, True, False, False, False,
               False, True, True, True, False, False]
    js = jax_scaler.make_loss_scale_state(True, 0.0, 8, 2)
    ps = loss_scaler.make_loss_scale_state(True, 0.0, 8, 2)
    for ov in pattern:
        js = jax_scaler.update_loss_scale(js, jnp.bool_(ov), loss_scale_window=3,
                                          hysteresis=2, min_loss_scale=16.0)
        ps = loss_scaler.update_loss_scale(ps, torch.tensor(ov), loss_scale_window=3,
                                           hysteresis=2, min_loss_scale=16.0)
        for k in ("scale", "growth_tracker", "hysteresis"):
            assert float(ps[k]) == float(js[k]), (k, ov)
    grads = {"a": torch.ones(3), "b": torch.tensor([1.0, float("inf")])}
    assert bool(loss_scaler.has_overflow(grads))
    assert bool(jax_scaler.has_overflow({k: jnp.asarray(v.numpy()) for k, v in grads.items()}))
    assert not bool(loss_scaler.has_overflow({"a": torch.ones(3)}))


@pytest.mark.parametrize("opt_type, wd", [("adamw", 0.1), ("adamw", 0.0), ("adam", 0.01)])
def test_fused_adam_matches_jax(opt_type, wd):
    rng = np.random.RandomState(3)
    shapes = {"w": (4, 5), "b": (5,), "e": (7, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = {"lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": wd}
    port = build_optimizer(opt_type, kw)
    ref = JaxAdam(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=wd,
                  adam_w_mode=(opt_type == "adamw"))
    assert isinstance(port, FusedAdam) and port.adam_w_mode == ref.adam_w_mode
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = ref.init(jp), port.init(pp)
    for step in range(3):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        lr = 1e-2 * (step + 1) / 3
        jp, js = ref.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                            lr=jnp.float32(lr))
        pp, ps = port.update({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp,
                             lr=torch.tensor(lr, dtype=torch.float32))
    assert int(ps["step"]) == int(js["step"]) == 3
    for k in shapes:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(ps["exp_avg_sq"][k].numpy(),
                                   np.asarray(js["exp_avg_sq"][k]), rtol=1e-6, atol=0)


def test_unported_optimizer_raises_by_name():
    with pytest.raises(NotImplementedError, match="lamb"):
        build_optimizer("lamb", {"lr": 1e-3})


def test_tree_helpers_match_jax():
    rng = np.random.RandomState(4)
    tree = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    want = float(jax_global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    cast = tree_cast({"a": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)},
                     torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #

T_ENGINE = 64


def _engine_config(bf16: bool):
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
            "gradient_clipping": 1.0, "bf16": {"enabled": bf16}, "steps_per_print": 0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "betas": [0.9, 0.95],
                                                      "eps": 1e-8, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0, "warmup_max_lr": 1e-3, "warmup_num_steps": 5}}}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (8, T_ENGINE)).astype(np.int32)}
            for _ in range(n)]


def _engines(bf16: bool):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    model = JaxGPT2(JaxGPT2Config.tiny(dtype=jdt))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 {"input_ids": jnp.zeros((1, T_ENGINE), jnp.int32)})["params"]
    # a 1-device mesh: the conftest's 8 virtual devices would make it 8 wide
    jeng, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=params, config=_engine_config(bf16),
        mesh_topology=build_topology(MeshConfig(data=1), devices=jax.devices()[:1]))
    pmodel = GPT2LMHead(GPT2Config.tiny(dtype=tdt), device="cpu", seed=1)
    peng, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=pmodel, model_parameters=_flat(params), config=_engine_config(bf16),
        device="cpu")
    assert opt is peng.optimizer and loader is None and sched is None
    return jeng, peng


def _streams(engine, batches, jax_side: bool):
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch(b)))
        norms.append(float(engine._last_metrics["grad_norm"]) if jax_side
                     else engine.get_global_grad_norm())
    return np.array(losses), np.array(norms)


@pytest.mark.parametrize("bf16, steps, rtol", [(False, 20, 1e-4), (True, 5, 2e-2)],
                         ids=["fp32-20-steps", "bf16-5-steps"])
def test_engine_loss_stream_matches_jax_engine(bf16, steps, rtol):
    """gas 2, clipping 1.0, AdamW with decay, WarmupLR, same converted
    weights and batches."""
    jeng, peng = _engines(bf16)
    batches = _batches(steps)
    jl, jn = _streams(jeng, batches, True)
    pl, pn = _streams(peng, batches, False)
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    np.testing.assert_allclose(pn, jn, rtol=rtol)
    assert peng.global_steps == steps and peng.get_skipped_steps() == 0
    assert peng.get_lr()[0] == pytest.approx(float(jeng.get_lr()[0]), rel=1e-6)
    assert set(peng.state) == set(jeng.state)
    assert peng.gradient_accumulation_steps() == jeng.gradient_accumulation_steps() == 2
    eval_batch = _batches(1, seed=9)[0]
    np.testing.assert_allclose(peng.eval_loss(eval_batch), jeng.eval_loss(eval_batch),
                               rtol=rtol)


def _port_engine(cfg=None):
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=2)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg or _engine_config(False),
                                                device="cpu")
    return engine


def test_train_steps_equals_per_step_train_batch_bytewise():
    batches = _batches(4, seed=5)
    a, b = _port_engine(), _port_engine()
    burst = a.train_steps(4, data_iter=iter(batches))
    single = np.array([float(b.train_batch(x)) for x in batches], np.float32)
    assert burst.dtype == np.float32 and burst.tobytes() == single.tobytes()
    for n in a.state["master"]:
        assert torch.equal(a.state["master"][n], b.state["master"][n]), n


def test_zero_stages_are_the_identity_on_one_device():
    cfg = _engine_config(False)
    batches = _batches(2, seed=6)
    ref = _port_engine(cfg).train_steps(2, data_iter=iter(batches))
    for stage in (1, 2, 3):
        eng = _port_engine(dict(cfg, zero_optimization={"stage": stage}))
        assert eng.zero_optimization_stage() == stage
        assert eng.train_steps(2, data_iter=iter(batches)).tobytes() == ref.tobytes()


def test_initialize_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model, config=_engine_config(False))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT2LMHead(GPT2Config.tiny())


@pytest.mark.parametrize("section, value, feature", [
    ("zero_optimization", {"offload_optimizer": {"device": "cpu"}},
     "zero_optimization.offload_optimizer"),
    ("zero_optimization", {"stage": 3, "offload_param": {"device": "nvme"}},
     "zero_optimization.offload_param"),
    ("tensorboard", {"enabled": True}, "tensorboard"),
    ("monitor", {"trace": {"enabled": True}}, "monitor.trace"),
    ("activation_checkpointing", {"partition_activations": True},
     "activation_checkpointing"),
    ("progressive_layer_drop", {"enabled": True}, "progressive_layer_drop"),
    ("curriculum_learning", {"enabled": True}, "curriculum_learning"),
    ("compression_training", {"weight_quantization": {}}, "compression_training"),
    ("hybrid_engine", {"enabled": True}, "hybrid_engine"),
    ("flops_profiler", {"enabled": True}, "flops_profiler"),
    ("checkpoint", {"rolling": {"every_n_steps": 5, "save_dir": "x"}}, "checkpoint.rolling"),
    ("train_pipeline", {"prefetch": 2}, "train_pipeline.prefetch"),
    ("mesh", {"fsdp": 2}, "mesh.fsdp"),
])
def test_unported_config_section_raises_by_name(section, value, feature):
    with pytest.raises(NotImplementedError, match=feature):
        DeepSpeedTPUConfig.load({"train_batch_size": 8, section: value})


def test_unported_engine_arguments_raise_by_name():
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="training_data"):
        deepspeed_tpu_torch.initialize(model=model, config=_engine_config(False),
                                       training_data=[1], device="cpu")
    engine = _port_engine()
    with pytest.raises(NotImplementedError, match="facade"):
        engine.forward(_batches(1)[0])


def test_fp16_overflow_skips_the_step_like_the_jax_engine():
    """fp16 with a dynamic scale that overflows once (step 5): the same
    scale stream, skipped count and step counter as the JAX engine, and
    losses at rtol 1e-3 (fp16 has 11 bits of mantissa, 2^-11 = 5e-4)."""
    cfg = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "steps_per_print": 0,
           "fp16": {"enabled": True, "initial_scale_power": 17, "hysteresis": 1,
                    "loss_scale_window": 2},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    model = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float16))
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (4, 32)).astype(np.int32)} for _ in range(8)]
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 {"input_ids": jnp.asarray(batches[0]["input_ids"][:1])})
    jeng, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=params["params"], config=cfg,
        mesh_topology=build_topology(MeshConfig(data=1), devices=jax.devices()[:1]))
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(GPT2Config.tiny(dtype=torch.float16), device="cpu"),
        model_parameters=_flat(params["params"]), config=cfg, device="cpu")
    for b in batches:
        np.testing.assert_allclose(float(peng.train_batch(b)), float(jeng.train_batch(b)),
                                   rtol=1e-3)
        for k in ("scale", "growth_tracker", "hysteresis"):
            assert float(peng.state["scaler"][k]) == float(jeng.state["scaler"][k]), k
        assert int(peng.state["step"]) == int(jeng.state["step"])
    assert peng.get_skipped_steps() == int(jeng.state["skipped"]) == 1
    assert int(peng.state["step"]) == len(batches) - 1


def test_causal_lm_loss_matches_jax():
    from deepspeed_tpu.models.llama import causal_lm_loss as jax_loss
    from deepspeed_tpu_torch.models.llama import causal_lm_loss
    rng = np.random.RandomState(7)
    logits = rng.randn(3, 9, 17).astype(np.float32)
    labels = rng.randint(0, 17, (3, 9)).astype(np.int32)
    np.testing.assert_allclose(float(causal_lm_loss(torch.from_numpy(logits),
                                                    torch.from_numpy(labels))),
                               float(jax_loss(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)
