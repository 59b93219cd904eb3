"""Activation checkpointing and progressive layer drop in the port (CPU),
mirroring ``tests/unit/test_activation_checkpointing.py`` where it needs no
flax, with the JAX package's chunking and PLD schedule as references.

Tolerances: checkpointed against plain autograd in the port, bit for bit
(the recompute runs the same ops on the same values); against JAX's
gradients, rtol 1e-5 and atol 2e-6, a few f32 ulps of the largest gradient
(~0.5; the same f32 chain, its matmuls summed in other orders); the PLD
schedule, rtol 1e-12 (one f64 expression on each side).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import activation_checkpointing as jac
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu_torch.config import DeepSpeedTPUConfig
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from deepspeed_tpu_torch.runtime import progressive_layer_drop as pld

from tests._torch_threads import one_torch_thread  # noqa: F401

# the module (the package re-exports its function under the same name)
k1 = importlib.import_module("deepspeed_tpu_torch.ops.kernels.flash_attention")


@pytest.fixture(autouse=True)
def _reset_ac():
    yield
    ac.reset()
    jac.reset()


def _params(seed=0, n=3, d=16):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32) for _ in range(n)]


def _mlp_loss(params, x):
    h = x
    for w in params:
        h = torch.tanh(h @ w)
    return torch.sum(h ** 2)


def _grads(fn, params, x):
    ps = [torch.from_numpy(p).requires_grad_() for p in params]
    return torch.autograd.grad(fn(ps, torch.from_numpy(x)), ps)


def test_checkpoint_matches_plain_grads():
    params = _params(0)
    x = np.random.default_rng(1).standard_normal((4, 16)).astype(np.float32)
    plain = _grads(_mlp_loss, params, x)
    ckpt = _grads(lambda p, x: ac.checkpoint(_mlp_loss, p, x), params, x)
    ref = jax.grad(lambda p, x: jnp.sum(jac.checkpoint(_jax_mlp, p, x) ** 2))(
        [jnp.asarray(p) for p in params], jnp.asarray(x))
    for a, b, r in zip(plain, ckpt, ref):
        assert torch.equal(a, b)
        np.testing.assert_allclose(b.numpy(), np.asarray(r), rtol=1e-5, atol=2e-6)


def _jax_mlp(params, x):
    h = x
    for w in params:
        h = jnp.tanh(h @ w)
    return h


def test_checkpoint_with_selective_policy():
    ac.configure(partition_activations=True)
    assert ac.is_configured()
    assert ac.current_policy() == ac.resolve_policy("dots_with_no_batch_dims_saveable")
    params = _params(2)
    x = np.random.default_rng(3).standard_normal((4, 16)).astype(np.float32)
    plain = _grads(_mlp_loss, params, x)
    for policy in (None, "dots_saveable", "everything_saveable", "nothing_saveable"):
        ckpt = _grads(lambda p, x: ac.checkpoint(_mlp_loss, p, x, policy=policy), params, x)
        for a, b in zip(plain, ckpt):
            assert torch.equal(a, b), policy


def test_configure_from_config_dict():
    cfg = DeepSpeedTPUConfig.load({
        "train_batch_size": 8,
        "activation_checkpointing": {"partition_activations": True,
                                     "cpu_checkpointing": False, "number_checkpoints": 2}})
    ac.configure(cfg)
    assert ac.is_configured() and ac.current_policy() is not None
    assert ac.layer_chunks(8) == [(0, 4), (4, 8)]


@pytest.mark.parametrize("num_checkpoints, n_layers", [
    (None, 3), (1, 5), (99, 4), (2, 8), (3, 8), (4, 6), (5, 7)])
def test_layer_chunks_match_jax(num_checkpoints, n_layers):
    ac.configure(num_checkpoints=num_checkpoints)
    jac.configure(num_checkpoints=num_checkpoints)
    assert ac.layer_chunks(n_layers) == jac.layer_chunks(n_layers)


def test_chunked_layers_grads_match_and_recompute():
    """number_checkpoints = 2 over 4 layers: two chunks, each recomputed
    once in the backward (its layers run twice), with plain autograd's
    gradients bit for bit."""
    ws = [torch.from_numpy(w) for w in _params(4, n=4)]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 16)).astype(np.float32))
    calls = []

    def layer(_, h, i):
        calls.append(i)
        return torch.tanh(h @ ws[i])

    def grads(remat):
        for w in ws:
            w.requires_grad_()
        out = ac.apply_checkpointed_layers(None, x, layer, 4, remat)
        return torch.autograd.grad(torch.sum(out ** 2), ws)

    plain = grads(False)
    ac.configure(num_checkpoints=2)
    calls.clear()
    chunked = grads(True)
    assert calls == [0, 1, 2, 3, 2, 3, 0, 1]
    for a, b in zip(plain, chunked):
        assert torch.equal(a, b)


def test_policy_registry_and_errors():
    assert ac.resolve_policy(None) is None
    assert ac.resolve_policy("dots_saveable") is not None
    assert torch.ops.aten.bmm.default in ac.resolve_policy("dots_saveable")
    assert torch.ops.aten.bmm.default not in ac.resolve_policy(
        "dots_with_no_batch_dims_saveable")
    # the host-offload policies resolve since the offload tier was ported:
    # the saving policies' ops, their outputs kept in host memory
    assert set(jac.POLICIES) == set(ac.POLICIES)
    with pytest.raises(ValueError):
        ac.resolve_policy("not-a-policy")
    for name, saving in (("offload_dots", "dots_with_no_batch_dims_saveable"),
                         ("offload_attn_out", "attn_out_saveable")):
        pol = ac.resolve_policy(name)
        assert isinstance(pol, ac.OffloadOps) and pol == ac.resolve_policy(saving)


def test_apply_remat_module_grads_match():
    torch.manual_seed(0)
    blocks = [torch.nn.Sequential(torch.nn.Linear(16, 16), torch.nn.Tanh()) for _ in range(3)]
    x = torch.randn(2, 16)

    def grads(remat):
        net = torch.nn.Sequential(*[ac.apply_remat(b, remat) for b in blocks])
        params = [p for b in blocks for p in b.parameters()]
        return torch.autograd.grad(torch.sum(net(x) ** 2), params)

    assert isinstance(ac.apply_remat(blocks[0], True), ac.RematModule)
    assert ac.apply_remat(blocks[0], False) is blocks[0]
    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)


def test_rng_tracker_fork_deterministic():
    tr = ac.RNGStatesTracker(device="cpu")
    tr.add("model-parallel-rng", 1234)
    with tr.fork() as g1:
        a = torch.randn(4, generator=g1)
    with tr.fork() as g2:
        b = torch.randn(4, generator=g2)
    assert not torch.allclose(a, b)  # the stream advances
    tr2 = ac.RNGStatesTracker(device="cpu")
    tr2.add("model-parallel-rng", 1234)
    with tr2.fork() as g3:
        c = torch.randn(4, generator=g3)
    assert torch.equal(a, c)  # same seed -> same stream
    states = tr.get_states()
    tr3 = ac.RNGStatesTracker(device="cpu")
    tr3.set_states(states)
    with tr.fork() as g4, tr3.fork() as g5:
        assert torch.equal(torch.randn(4, generator=g4), torch.randn(4, generator=g5))
    with pytest.raises(ValueError):
        tr.add("model-parallel-rng", 0)
    with pytest.raises(KeyError):
        with tr.fork("other"):
            pass


def test_model_parallel_seed_decorrelates_ranks():
    g0 = ac.model_parallel_seed(7, tp_rank=0, device="cpu")
    g1 = ac.model_parallel_seed(7, tp_rank=1, device="cpu")
    assert not torch.equal(torch.rand(8, generator=g0), torch.rand(8, generator=g1))
    assert torch.equal(torch.rand(8, generator=ac.model_parallel_seed(7, 1, device="cpu")),
                       torch.rand(8, generator=ac.model_parallel_seed(7, 1, device="cpu")))


def test_rng_tracker_defaults_to_the_card(monkeypatch):
    """A tracker built with no device (the module-level one included) makes
    no CPU generator: it asks for CUDA when a state is added, and raises on
    a machine without it, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = ac.RNGStatesTracker()
    assert tr.device is None and ac.get_cuda_rng_tracker().device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.add("model-parallel-rng", 1234)
    assert tr.states_ == {}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.set_states({"x": torch.Generator().get_state()})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ac.model_parallel_seed(7, 0)


def test_cpu_checkpointing_refused_by_name():
    # cpu_checkpointing configures since the offload tier was ported: it
    # selects offload_dots, as in the JAX package
    ac.configure(checkpoint_in_cpu=True)
    assert ac.current_policy() == ac.resolve_policy("offload_dots")
    assert isinstance(ac.current_policy(), ac.OffloadOps)
    cfg = DeepSpeedTPUConfig.load({"train_batch_size": 8,
                                   "activation_checkpointing": {"cpu_checkpointing": True}})
    ac.configure(cfg)
    jac.configure(checkpoint_in_cpu=True)
    assert ac.is_configured() and jac.is_configured()
    assert isinstance(ac.current_policy(), ac.OffloadOps)


# --------------------------------------------------------------------------- #
# the models' checkpointed layers and K1's forward
# --------------------------------------------------------------------------- #

MODELS = {
    "gpt2": lambda **kw: GPT2LMHead(GPT2Config.tiny(**kw), device="cpu", seed=0),
    "llama": lambda **kw: LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu", seed=0),
}
REMAT = [(False, None), (True, None), (True, "nothing_saveable"), (True, "dots_saveable"),
         (True, "dots_with_no_batch_dims_saveable"), (True, "attn_out_saveable"),
         (True, "everything_saveable")]


def _loss_grads(model, ids):
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    loss = model({"input_ids": ids})
    return loss.detach(), torch.autograd.grad(loss, params)


@pytest.mark.parametrize("family", sorted(MODELS))
def test_model_remat_policies_are_bit_equal_and_count_k1(family, monkeypatch):
    """Every policy gives remat-off's loss and gradients bit for bit; K1's
    forward runs once a layer without remat and under attn_out_saveable
    (its output is saved), twice under full recompute."""
    calls = {"n": 0}
    fwd = k1.flash_attention_fwd

    def counted(*args):
        calls["n"] += 1
        return fwd(*args)

    monkeypatch.setattr(k1, "flash_attention_fwd", counted)
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 24)))
    ref = None
    for remat, policy in REMAT:
        calls["n"] = 0
        loss, grads = _loss_grads(MODELS[family](remat=remat, remat_policy=policy), ids)
        full = remat and policy in (None, "nothing_saveable", "dots_saveable",
                                    "dots_with_no_batch_dims_saveable")
        assert calls["n"] == (4 if full else 2), (remat, policy)
        if ref is None:
            ref = loss, grads
            continue
        assert torch.equal(loss, ref[0]), (remat, policy)
        assert all(torch.equal(a, b) for a, b in zip(grads, ref[1])), (remat, policy)


@pytest.mark.parametrize("family", sorted(MODELS))
@pytest.mark.parametrize("offload, saving", [
    ("offload_dots", "dots_with_no_batch_dims_saveable"),
    ("offload_attn_out", "attn_out_saveable")])
def test_offload_policies_equal_the_saving_policies(family, offload, saving, monkeypatch):
    """A host-offload policy gives its saving policy's loss and gradients
    bit for bit, runs K1's forward as often, and its saved outputs left
    the device's custody: each went through the host copy (here a CPU copy
    without pinning), and those the recompute reads came back."""
    calls = {"n": 0}
    fwd = k1.flash_attention_fwd

    def counted(*args):
        calls["n"] += 1
        return fwd(*args)

    monkeypatch.setattr(k1, "flash_attention_fwd", counted)
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 24)))
    hops = {"to": 0, "back": 0}
    to_host, from_host = ac._to_host, ac._from_host

    def counting_to(x):
        hops["to"] += isinstance(x, torch.Tensor)
        return to_host(x)

    def counting_back(e):
        hops["back"] += isinstance(e, ac._Host)
        return from_host(e)

    monkeypatch.setattr(ac, "_to_host", counting_to)
    monkeypatch.setattr(ac, "_from_host", counting_back)
    ac.OFFLOAD_STATS.update(tensors=0, bytes=0)
    loss, grads = _loss_grads(MODELS[family](remat=True, remat_policy=offload), ids)
    n_off, moved = calls["n"], dict(ac.OFFLOAD_STATS)
    calls["n"] = 0
    ref_loss, ref_grads = _loss_grads(MODELS[family](remat=True, remat_policy=saving), ids)
    assert calls["n"] == n_off
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    # the recompute stops once the backward has what it needs, so a
    # region's last saved outputs may never come back
    assert moved["tensors"] > 0 and hops["to"] == moved["tensors"]
    assert 0 < hops["back"] <= hops["to"] and moved["bytes"] > 0


def test_named_saveable_policy_and_cpu_checkpointing_in_a_model():
    """``named_saveable_policy(["attn_out"], offload=True)`` is
    ``offload_attn_out``; a model under ``cpu_checkpointing`` (no policy of
    its own) offloads the dots and gives remat-off's bits."""
    assert ac.named_saveable_policy(["attn_out"]) == ac.resolve_policy("attn_out_saveable")
    pol = ac.named_saveable_policy(["attn_out"], offload=True)
    assert isinstance(pol, ac.OffloadOps) and pol == ac.resolve_policy("offload_attn_out")
    with pytest.raises(ValueError):
        ac.named_saveable_policy(["not_a_tag"])
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 24)))
    ref = _loss_grads(MODELS["llama"](), ids)
    ac.configure(checkpoint_in_cpu=True)
    ac.OFFLOAD_STATS.update(tensors=0, bytes=0)
    got = _loss_grads(MODELS["llama"](remat=True), ids)
    assert ac.OFFLOAD_STATS["tensors"] > 0
    assert torch.equal(got[0], ref[0]) and all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))


# --------------------------------------------------------------------------- #
# progressive layer drop
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("theta, gamma", [(0.5, 0.001), (0.2, 0.1), (0.9, 0.05)])
def test_pld_schedule_matches_jax(theta, gamma):
    a, b = pld.ProgressiveLayerDrop(theta, gamma), jpld.ProgressiveLayerDrop(theta, gamma)
    assert a.get_theta() == b.get_theta() == 1.0
    for step in (0, 1, 7, 100, 5000):
        np.testing.assert_allclose(a.theta_at(step), b.theta_at(step), rtol=1e-12)
        a.update_state(step)
        b.update_state(step)
        assert a.get_state() == pytest.approx(b.get_state())
        for i in range(6):
            np.testing.assert_allclose(a.keep_prob(i, 6), b.keep_prob(i, 6), rtol=1e-12)
            np.testing.assert_allclose(pld.pld_keep_prob(i, 6, a.current_theta),
                                       float(jpld.pld_keep_prob(i, 6, b.current_theta)),
                                       rtol=1e-12)


def test_pld_layer_draws():
    keeps = pld.layer_keeps(123, 0.5, 12)
    assert keeps == pld.layer_keeps(123, 0.5, 12)         # a seed replays its draws
    assert keeps[0] and not all(keeps)                    # layer 0 always runs
    assert all(pld.layer_keeps(5, 1.0, 12))               # theta 1 keeps every layer
    n = sum(sum(pld.layer_keeps(s, 0.5, 4)[1:]) for s in range(400))
    want = 400 * sum(pld.pld_keep_prob(i, 4, 0.5) for i in range(1, 4))
    assert abs(n - want) < 0.1 * want                     # the keep rates hold
    x_new, x_skip = torch.full((3,), 5.0), torch.full((3,), 1.0)
    assert torch.equal(pld.apply_layer_drop(x_new, x_skip, 1.0, True), x_new)
    assert torch.equal(pld.apply_layer_drop(x_new, x_skip, 0.5, False), x_skip)
    assert torch.equal(pld.apply_layer_drop(x_new, x_skip, 0.5, True), torch.full((3,), 9.0))


@pytest.mark.parametrize("family", sorted(MODELS))
def test_model_pld_theta_one_is_pld_off(family):
    """At theta 1 every keep probability is 1: the loss and gradients are
    PLD-off's bit for bit; at theta 0.1 a dropped layer's parameters get no
    gradient and the loss moves."""
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 24)))
    off = _loss_grads(MODELS[family](), ids)
    model = MODELS[family]()
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    for remat in (False, True):
        m = MODELS[family](remat=remat)
        for p in m.parameters():
            p.requires_grad_(True)
        batch = {"input_ids": ids, "pld_theta": torch.ones(2), "pld_rng": torch.tensor([3, 4])}
        loss = m(batch)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        assert torch.equal(loss.detach(), off[0])
        assert all(torch.equal(a, b) for a, b in zip(grads, off[1]))
    n_layers = 2
    seed = next(s for s in range(100) if not all(pld.layer_keeps(s, 0.1, n_layers)))
    batch = {"input_ids": ids, "pld_theta": torch.full((2,), 0.1),
             "pld_rng": torch.tensor([seed, 0])}
    loss = model(batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    assert any(g is None for g in grads) and not torch.equal(loss.detach(), off[0])
