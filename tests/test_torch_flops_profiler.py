"""The port's flops profiler (``deepspeed_tpu_torch.profiling``) on the JAX
package's profiler tests, and against the JAX package: on tiny GPT-2 and
tiny Llama the per-module table (paths, MACs, flops, params, calls) and the
MAC and parameter totals equal the JAX profiler's exactly, once the flax
Llama's one-row kernel-making ``lm_head`` call is taken out; the counted
end-to-end forward flops (``FlopCounterMode``) equal the closed form from
the shapes; K1's registered flop formula counts what its plain version's
two matmuls count. Every comparison is exact (integer counts)."""

import csv

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.profiling import FlopsProfiler as JaxFlopsProfiler
from deepspeed_tpu_torch.models.gpt2 import Dense, GPT2Config, GPT2LMHead, LayerNorm
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.ops.kernels.flash_attention import (flash_attention,
                                                             flash_attention_fwd_plain)
from deepspeed_tpu_torch.profiling import FlopsProfiler, get_model_profile

from tests._torch_threads import one_torch_thread  # noqa: F401


class TwoLayer(torch.nn.Module):
    """The JAX tests' ``TwoLayer`` from the port's flax-named layers."""

    def __init__(self):
        super().__init__()
        self.fc1 = Dense(16, 32, torch.float32, "cpu")
        self.ln = LayerNorm(32, 1e-5, torch.float32, "cpu")
        self.fc2 = Dense(32, 8, torch.float32, "cpu")
        with torch.no_grad():
            for p in self.parameters():
                p.fill_(0.1)

    def forward(self, x):
        return self.fc2(self.ln(F.relu(self.fc1(x))))


def test_dense_macs_counted():
    prof = FlopsProfiler()
    prof.start_profile(TwoLayer(), torch.zeros(4, 16))
    expected = 4 * 32 * 16 + 4 * 8 * 32
    assert prof.get_total_macs() == expected
    assert prof.total_flops_analytic == 2 * expected + 5 * 4 * 32
    assert prof.get_total_params() == 16 * 32 + 32 + 64 + 32 * 8 + 8
    assert "fc1" in str(sorted(prof.modules))


def test_measure_and_report(tmp_path):
    model = TwoLayer()
    x = torch.zeros(4, 16)
    prof = FlopsProfiler()
    prof.start_profile(model, x)
    prof.measure(model, x)
    assert prof.latency_s is not None and prof.latency_s > 0
    # FlopCounterMode counts the two matmuls (the bias adds and the norm are
    # not matmuls)
    assert prof.counted_flops == 2 * (4 * 32 * 16 + 4 * 8 * 32)
    out = str(tmp_path / "profile.txt")
    report = prof.print_model_profile(output_file=out)
    assert "Flops Profiler" in report and "FlopCounterMode" in report
    with open(out) as f:
        assert "params" in f.read()


def test_get_model_profile():
    flops, macs, params = get_model_profile(TwoLayer(), torch.zeros(2, 16))
    assert macs == 2 * 32 * 16 + 2 * 8 * 32
    assert flops >= 2 * macs
    assert params > 0


def _gpt2_engine(extra):
    cfg = {"train_batch_size": 8, "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    cfg.update(extra)
    return deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=0), config=cfg,
        device="cpu")[0]


def test_engine_flops_profiler_hook(tmp_path):
    out = str(tmp_path / "prof.txt")
    engine = _gpt2_engine({"flops_profiler": {"enabled": True, "profile_step": 1,
                                              "output_file": out}})
    engine.train_batch({"input_ids": np.zeros((8, 16), np.int32)})
    assert engine.flops_profiler is not None
    with open(out) as f:
        assert "MACs" in f.read()
    engine.destroy()


def test_events_monitor_shape():
    prof = FlopsProfiler()
    prof.start_profile(TwoLayer(), torch.zeros(4, 16))
    ev = prof.events(step=64, top_modules=2)
    named = {name: value for name, value, _ in ev}
    assert all(name.startswith("train/flops/") for name in named)
    assert all(step == 64 for _, _, step in ev)
    assert named["train/flops/macs"] == prof.get_total_macs()
    assert named["train/flops/params"] == prof.get_total_params()
    mods = [n for n in named if n.startswith("train/flops/module/")]
    assert len(mods) == 2
    assert "train/flops/module/fc1" in mods
    prof.end_profile()


def test_engine_routes_flops_events_to_monitor(tmp_path):
    engine = _gpt2_engine({"flops_profiler": {"enabled": True, "profile_step": 1,
                                              "output_file": str(tmp_path / "p.txt"),
                                              "top_modules": 3},
                           "csv_monitor": {"enabled": True, "output_path": str(tmp_path),
                                           "job_name": "flops_job"}})
    engine.train_batch({"input_ids": np.zeros((8, 16), np.int32)})
    job = tmp_path / "flops_job"
    with open(job / "train_flops_macs.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2 and float(rows[1][1]) > 0
    assert any(p.name.startswith("train_flops_module_") for p in job.iterdir())
    # the end-to-end count is the counted one, under its own name
    assert (job / "train_flops_flops_counted.csv").exists()
    engine.destroy()


# --------------------------------------------------------------------------- #
# against the JAX package, and the closed form
# --------------------------------------------------------------------------- #

B, T = 2, 16


def _table(prof):
    return {k: (v.macs, v.flops, v.params, v.calls) for k, v in prof.modules.items()}


def _jax_profile(model):
    ids = np.zeros((B, T), np.int32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), {"input_ids": ids})
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    prof = JaxFlopsProfiler()
    prof.start_profile(model, variables, {"input_ids": ids})
    return prof


def _without_kernel_making_call(prof, table):
    """The flax Llama calls ``lm_head`` on one row only to make its kernel
    before the chunked loss reads it; its table counts that call. The port's
    loss reads the head's weight and never calls the module, so the row and
    its share of every ancestor (the root's too) leave the JAX side here;
    the totals come back with them."""
    row = prof.modules.get("lm_head")
    if row is None:
        return table, (prof.total_macs, prof.total_flops_analytic)
    table = {k: (v[0] - row.macs, v[1] - row.flops, v[2], v[3]) if k == "<root>" else v
             for k, v in table.items() if k != "lm_head"}
    return table, (prof.total_macs - row.macs, prof.total_flops_analytic - row.flops)


def _gpt2_closed_form(cfg):
    """2 x every matmul's MACs (the four projections, the tied head over the
    T - 1 labelled positions) plus K1's 4 * B * H * T * T * D a layer."""
    C = cfg.n_embd
    layer = B * T * (3 * C * C + C * C + 2 * cfg.mlp_ratio * C * C)
    head = B * (T - 1) * cfg.vocab_size * C
    return 2 * (cfg.n_layer * layer + head) + cfg.n_layer * 4 * B * T * T * C


def _llama_closed_form(cfg):
    hid, D = cfg.hidden_size, cfg.head_dim
    H, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    layer = B * T * (2 * hid * H * D + 2 * hid * Hkv * D + 3 * hid * cfg.intermediate_size)
    head = B * (T - 1) * cfg.vocab_size * hid
    return 2 * (cfg.num_hidden_layers * layer + head) + \
        cfg.num_hidden_layers * 4 * B * H * T * T * D


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_per_module_table_matches_jax_and_counted_flops_match_closed_form(family):
    if family == "gpt2":
        jax_model, cfg = JaxGPT2(JaxGPT2Config.tiny()), GPT2Config.tiny()
        port, closed = GPT2LMHead(cfg, device="cpu", seed=0), _gpt2_closed_form(cfg)
    else:
        jax_model, cfg = JaxLlama(JaxLlamaConfig.tiny()), LlamaConfig.tiny()
        port, closed = LlamaForCausalLM(cfg, device="cpu", seed=0), _llama_closed_form(cfg)
    jp = _jax_profile(jax_model)
    batch = {"input_ids": torch.zeros(B, T, dtype=torch.long)}
    pp = FlopsProfiler()
    pp.start_profile(port, batch)
    jtable, jtotals = _without_kernel_making_call(jp, _table(jp))
    assert (family == "llama") == ("lm_head" in jp.modules)
    assert _table(pp) == jtable
    assert (pp.total_macs, pp.total_flops_analytic, pp.total_params) == (*jtotals, jp.total_params)
    # the hooks are gone after the profile: the training forward is as before
    assert not any(m._forward_hooks for m in port.modules())
    pp.measure(port, batch, n_iters=1)
    assert pp.counted_flops == closed


def test_k1_flop_formula_counts_the_plain_path():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 24, 4, 16, generator=g) for _ in range(3))
    with FlopCounterMode(display=False) as op_count:
        flash_attention(q, k, v, causal=True)
    with FlopCounterMode(display=False) as plain_count:
        flash_attention_fwd_plain(q, k, v, True, 0.25)
    assert op_count.get_total_flops() == plain_count.get_total_flops() == 4 * 2 * 4 * 24 * 24 * 16
