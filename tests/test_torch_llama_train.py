"""The port's Llama training forward and its engine against the JAX
package's (CPU; the port runs K1's plain versions, the JAX package its
dense attention), on the same numpy weights (shapes from
``jax.eval_shape``) and batches.

Tolerances, each with its reason:
- the loss rtol 1e-5 / atol 1e-6 and every gradient rtol 1e-4 / atol 1e-6,
  in f32: the same products summed in other orders through two layers, a
  softmax over the vocabulary and (Gemma) a tanh GELU, as the GPT-2 tests;
- the engine's loss stream, fp32 with FusedLamb over 3 steps: rtol 1e-4
  (per-step f32 differences of ~1e-7 compound through LAMB's trust ratio);
- within the port, bit for bit: remat on and off, the facade and
  ``train_batch``, prefetch 0 and 2, grouped and whole optimizer updates,
  and every byte read from a checkpoint file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import state as jax_state
from deepspeed_tpu.comm.mesh import build_topology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.checkpoint import state
from deepspeed_tpu_torch.checkpoint.convert import params_from_flat
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

from tests._torch_threads import one_torch_thread  # noqa: F401

T = 32
# name -> LlamaConfig.tiny overrides (GQA 4/2 throughout)
FLAGS = {
    "llama": {},
    "qwen2": {"qkv_bias": True},
    "gemma": {"embed_scale_by_sqrt_dim": True, "norm_plus_one": True, "mlp_act": "gelu"},
}


@pytest.fixture(autouse=True)
def _reset_ac():
    yield
    ac.reset()


def _shapes(kw):
    model = JaxLlama(JaxLlamaConfig.tiny(**kw))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                 {"input_ids": jnp.zeros((1, T), jnp.int32)})["params"]


def _numpy_params(shapes, seed=0):
    """Seeded numpy weights: N(0, 1/fan_in) projections, N(0, 0.5)
    embeddings, norms about 1 (about 0 with ``norm_plus_one``: random
    either way), small biases."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in jax_state.flatten_tree(shapes).items():
        if k.endswith("kernel"):
            v = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        elif k.endswith("embedding"):
            v = 0.5 * rng.standard_normal(s.shape)
        elif k.endswith("bias"):
            v = 0.1 * rng.standard_normal(s.shape)
        else:
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        flat[k] = v.astype(np.float32)
    return flat


def _ids(n=2, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, T)).astype(np.int32)


def _port_model(kw, flat, **cfg):
    model = LlamaForCausalLM(LlamaConfig.tiny(**kw, **cfg), device="cpu", seed=3)
    model.load_flat(params_from_flat(flat, device="cpu"))
    for p in model.parameters():
        p.requires_grad_(True)
    return model


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_training_loss_and_grads_match_jax(name):
    kw = FLAGS[name]
    model, shapes = _shapes(kw)
    flat = _numpy_params(shapes)
    params = jax_state.unflatten_into(shapes, flat)
    ids = _ids()
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply({"params": p}, {"input_ids": jnp.asarray(ids)})))(params)
    port = _port_model(kw, flat)
    named = port.named_flat_parameters()
    loss = port({"input_ids": torch.from_numpy(ids)})
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5, atol=1e-6)
    ref = {k: np.asarray(v) for k, v in jax_state.flatten_tree(ref_grads).items()}
    assert set(grads) == set(ref)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # bare ids are their own labels, as in the JAX model
    assert torch.equal(port(torch.from_numpy(ids)).detach(), loss.detach())


@pytest.mark.parametrize("num_checkpoints", [None, 1, 2])
def test_remat_on_equals_off_bit_for_bit(num_checkpoints):
    kw = dict(FLAGS["llama"], num_hidden_layers=4)
    flat = _numpy_params(_shapes(kw)[1])
    ids = torch.from_numpy(_ids())
    ac.configure(num_checkpoints=num_checkpoints)
    assert ac.layer_chunks(4) == {None: [(0, 1), (1, 2), (2, 3), (3, 4)], 1: [(0, 4)],
                                  2: [(0, 2), (2, 4)]}[num_checkpoints]
    out = []
    for remat in (False, True):
        m = _port_model(kw, flat, remat=remat)
        loss = m({"input_ids": ids})
        out.append((loss.detach(), torch.autograd.grad(loss, list(m.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_unported_llama_training_options_raise_by_name():
    for feature in ("sequence_parallel", "context_parallel"):
        with pytest.raises(NotImplementedError, match=feature):
            LlamaConfig.tiny(**{feature: True})
    model = LlamaForCausalLM(LlamaConfig.tiny(sliding_window=16), device="cpu")
    with pytest.raises(NotImplementedError, match="sliding window"):
        model({"input_ids": torch.zeros((1, 24), dtype=torch.long)})
    # at T <= window attention is plain causal
    assert torch.isfinite(model({"input_ids": torch.zeros((1, 16), dtype=torch.long)}))


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #

def _config(prefetch=0, remat_chunks=None):
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "steps_per_print": 0,
           "gradient_clipping": 1.0,
           "optimizer": {"type": "Lamb", "params": {"lr": 2e-3, "weight_decay": 0.01,
                                                    "betas": [0.9, 0.95]}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_min_lr": 0, "warmup_max_lr": 2e-3, "warmup_num_steps": 3}},
           "train_pipeline": {"prefetch": prefetch}}
    if remat_chunks is not None:
        cfg["activation_checkpointing"] = {"number_checkpoints": remat_chunks}
    return cfg


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (8, T)).astype(np.int32)} for _ in range(n)]


def _jax_engine(flat, shapes, model):
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=jax_state.unflatten_into(shapes, flat), config=_config(),
        mesh_topology=build_topology(MeshConfig(data=1), devices=jax.devices()[:1]))
    return engine


def _port_engine(flat, cfg=None, seed=1, training_data=None, **model_kw):
    model = LlamaForCausalLM(LlamaConfig.tiny(**model_kw), device="cpu", seed=seed)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=flat, training_data=training_data,
        config=cfg or _config(), device="cpu")
    return engine


def _master(engine):
    return {k: v.detach().clone() for k, v in engine.state["master"].items()}


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX engine trains the 5 batches with FusedLamb, saving
    ``global_step2`` on the way; the port engine does the same."""
    model, shapes = _shapes(FLAGS["llama"])
    flat = _numpy_params(shapes)
    root = tmp_path_factory.mktemp("llama_ckpt")
    batches = _batches(5)
    out = {"flat": flat, "shapes": shapes, "model": model, "root": root, "batches": batches}
    for side in ("jax", "port"):
        eng = _jax_engine(flat, shapes, model) if side == "jax" else _port_engine(flat)
        losses = [float(eng.train_batch(b)) for b in batches[:2]]
        eng.save_checkpoint(str(root / side))
        losses += [float(eng.train_batch(b)) for b in batches[2:]]
        out[side] = np.array(losses)
        if side == "port":
            eng.destroy()
    return out


def test_engine_lamb_loss_stream_matches_jax(jax_runs):
    np.testing.assert_allclose(jax_runs["port"], jax_runs["jax"], rtol=1e-4)
    assert jax_runs["port"][-1] < jax_runs["port"][0]


def test_jax_llama_tag_resumes_in_the_port(jax_runs):
    eng = _port_engine(jax_runs["flat"], seed=5)
    eng.load_checkpoint(str(jax_runs["root"] / "jax"), tag="global_step2", verify=True)
    assert (eng.global_steps, eng.global_samples, eng.micro_steps) == (2, 16, 4)
    saved = dict(np.load(str(jax_runs["root"] / "jax" / "global_step2" / state.MODEL_FILE)))
    assert set(saved) == set(eng.state["master"])
    for k, a in saved.items():
        assert eng.state["master"][k].detach().numpy().tobytes() == a.tobytes(), k
    losses = [float(eng.train_batch(b)) for b in jax_runs["batches"][2:]]
    np.testing.assert_allclose(losses, jax_runs["jax"][2:], rtol=1e-4)
    eng.destroy()


def test_port_llama_tag_resumes_in_the_jax_engine(jax_runs):
    eng = _jax_engine(jax_runs["flat"], jax_runs["shapes"], jax_runs["model"])
    eng.load_checkpoint(str(jax_runs["root"] / "port"), tag="global_step2", verify=True)
    saved = dict(np.load(str(jax_runs["root"] / "port" / "global_step2" / state.MODEL_FILE)))
    live = {k: np.asarray(v) for k, v in jax_state.flatten_tree(eng.state["master"]).items()}
    assert set(saved) == set(live)
    for k, a in saved.items():
        assert live[k].tobytes() == a.tobytes(), k
    assert int(eng.state["step"]) == 2
    losses = [float(eng.train_batch(b)) for b in jax_runs["batches"][2:]]
    np.testing.assert_allclose(losses, jax_runs["port"][2:], rtol=1e-4)


def test_facade_equals_train_batch_bit_for_bit():
    """gas 2 facade micro-steps (forward, backward, step) give the bits of
    train_batch: the same losses and masters after 3 steps."""
    flat = _numpy_params(_shapes(FLAGS["llama"])[1])
    batches = _batches(3, seed=4)
    a, b = _port_engine(flat), _port_engine(flat)
    whole = [a.train_batch(x) for x in batches]
    facade = []
    for x in batches:
        micro = []
        for g in range(2):
            loss = b({k: v[4 * g:4 * g + 4] for k, v in x.items()})
            b.backward(loss)
            assert b.is_gradient_accumulation_boundary() == (g == 1)
            b.step()
            micro.append(loss.detach())
        facade.append(torch.stack(micro).mean())
    assert torch.equal(torch.stack(whole), torch.stack(facade))
    assert _same(_master(a), _master(b))
    assert (b.global_steps, b.micro_steps) == (a.global_steps, a.micro_steps) == (3, 6)
    assert torch.equal(a.state["opt"]["step"], b.state["opt"]["step"])


def test_initialize_trains_llama_from_training_data():
    """initialize(model=Llama, training_data=..., Lamb, activation
    checkpointing, prefetch 2) trains; prefetch 0 and remat off give the
    same bits."""
    flat = _numpy_params(_shapes(FLAGS["llama"])[1])
    rng = np.random.default_rng(6)
    data = [{"input_ids": rng.integers(0, 256, T).astype(np.int32)} for _ in range(40)]

    def run(prefetch, remat):
        eng = _port_engine(flat, cfg=_config(prefetch, remat_chunks=1 if remat else None),
                           training_data=data, remat=remat)
        out = eng.train_steps(4), _master(eng)
        eng.destroy()
        return out

    ref = run(2, True)
    assert np.isfinite(ref[0]).all()
    for other in (run(0, True), run(2, False), run(0, False)):
        assert other[0].tobytes() == ref[0].tobytes()
        assert _same(other[1], ref[1])
