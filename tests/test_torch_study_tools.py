"""The port's study tools against the JAX package on the CPU:
``t5_encode(collect_hiddens=True)``, the bf16 drift study at a tiny config,
and decode_profile's bucketing of a trace (the int8 drift study:
tests/test_torch_int8_drift.py)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.ops.decoding import (  # noqa: E402
    greedy_decode_t5 as jax_greedy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    t5_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    bf16_drift_study,
    decode_profile,
)

CPU = torch.device("cpu")
LAYER_REL = 1e-3     # each per-layer error within 1e-3 of JAX's, relative
BF16_NOISE = 5e-2    # bf16-vs-fp32 errors: two bf16 computes' noise levels


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_port(jparams, dtype):
    return t5_params_from_numpy(to_numpy(jparams), dtype, "cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_collect_hiddens_matches_jax(fused):
    """JAX's return shape ((B, L, D), (layers, B, L, D)) and values within
    1e-5 relative, on the plain and on the fused attention path."""
    widths = dict(d_model=64, d_ff=128, num_heads=4, d_kv=16,
                  num_encoder_layers=3, num_decoder_layers=2,
                  fused_encoder_attention=fused)
    jcfg = jt5.T5Config.small_test(**widths)
    tcfg = tt5.T5Config.small_test(**widths)
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 2000, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, -4:] = 0
    jfinal, jper = jt5.t5_encode(jp, jcfg, input_ids=jnp.asarray(ids),
                                 attention_mask=jnp.asarray(mask),
                                 collect_hiddens=True)
    tfinal, tper = tt5.t5_encode(
        to_port(jp, torch.float32), tcfg, input_ids=torch.as_tensor(ids),
        attention_mask=torch.as_tensor(mask), collect_hiddens=True)
    assert tuple(tper.shape) == np.asarray(jper).shape == (3, 2, 12, 64)
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal),
                               rtol=1e-5, atol=1e-5)
    # without the flag: the final states alone, as before
    alone = tt5.t5_encode(to_port(jp, torch.float32), tcfg,
                          input_ids=torch.as_tensor(ids),
                          attention_mask=torch.as_tensor(mask))
    torch.testing.assert_close(alone, tfinal, rtol=0, atol=0)


# --- bf16 drift study ---------------------------------------------------------

def test_bf16_drift_study_matches_jax():
    """The study's function at a tiny config against the same metrics of
    JAX's t5_encode / t5_decode / greedy_decode_t5 on the same params: the
    fp32 compute equal to JAX's (logits within 1e-5, tokens equal), the
    greedy tokens of both computes equal to JAX's, so the sequence match
    rates equal. The two bf16 computes round in different places (XLA
    keeps fp32 across a fusion; PyTorch rounds each operator's output), so
    their states part by about as much as each parts from fp32 (0.4-0.9 %
    here): the errors, a measure of that rounding noise, are held within
    5 % of JAX's (2-3.5 % read), the bf16 argmax equal to JAX's wherever
    JAX's top-2 margin exceeds twice the two computes' largest logit
    distance, and the top-1 rates apart by at most the share of positions
    closer than that."""
    widths = dict(vocab_size=512, d_model=64, d_kv=16, num_heads=4,
                  d_ff=128, num_encoder_layers=3, num_decoder_layers=2)
    jcfg32 = jt5.T5Config(**widths, dtype=jnp.float32)
    tcfg32 = tt5.T5Config(**widths, dtype=torch.float32)
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), jcfg32, jnp.float32)
    tp = to_port(jp, torch.float32)
    shapes = dict(batch=2, length=12, dec_len=4, dec_batch=4, max_new=5)
    inputs = bf16_drift_study.study_inputs(shapes, 500, CPU)
    max_new = shapes["max_new"]
    got = bf16_drift_study.study(tp, tcfg32, inputs, max_new)

    j = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}

    def jax_compute(cfg):
        final, per_layer = jt5.t5_encode(jp, cfg, input_ids=j["ids"],
                                         attention_mask=j["mask"],
                                         collect_hiddens=True)
        logits = jt5.t5_decode(jp, cfg, j["dec_ids"], final, j["mask"])
        hidden = jt5.t5_encode(jp, cfg, input_ids=j["ids_d"],
                               attention_mask=j["mask_d"])
        tokens, lps = jax_greedy(jp, cfg, hidden, j["mask_d"],
                                 max_new_tokens=max_new)
        return ((np.asarray(per_layer, np.float32),
                 np.asarray(logits, np.float32)),
                (np.asarray(tokens), np.asarray(lps, np.float32)))

    jcfg16 = dataclasses.replace(jcfg32, dtype=jnp.bfloat16)
    (j32, jd32), (j16, jd16) = jax_compute(jcfg32), jax_compute(jcfg16)
    want = bf16_drift_study.drift_metrics(j32, j16, jd32, jd16, max_new)
    (t32, td32) = bf16_drift_study.run_compute(tp, tcfg32, inputs, max_new)
    (t16, td16) = bf16_drift_study.run_compute(
        tp, dataclasses.replace(tcfg32, dtype=torch.bfloat16), inputs,
        max_new)
    np.testing.assert_allclose(t32[1], j32[1], rtol=1e-5, atol=1e-5)
    for tok, jtok in ((td32[0], jd32[0]), (td16[0], jd16[0])):
        np.testing.assert_array_equal(tok, jtok)
    for key in ("full_sequence_match_rate", "mean_first_flip_step",
                "per_step_flip_rate_on_trajectory"):
        assert got["greedy_decode"][key] == want["greedy_decode"][key], key
    for key in ("per_layer_rel_error", "logit_rel_error"):
        np.testing.assert_allclose(got[key], want[key], rtol=BF16_NOISE,
                                   err_msg=key)
    np.testing.assert_allclose(
        got["greedy_decode"]["on_trajectory_logprob_mean_abs_diff"],
        want["greedy_decode"]["on_trajectory_logprob_mean_abs_diff"],
        rtol=0.25)

    apart = float(np.abs(t16[1] - j16[1]).max())
    top2 = np.sort(j16[1], -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * apart
    assert clear.mean() >= 0.75
    np.testing.assert_array_equal(t16[1].argmax(-1)[clear],
                                  j16[1].argmax(-1)[clear])
    assert abs(got["logit_top1_match"] - want["logit_top1_match"]) <= (
        1 - clear.mean())
    rounded = bf16_drift_study.rounded(got)
    assert rounded["greedy_decode"]["batch"] == 4
    assert len(rounded["per_layer_rel_error"]) == 3


# --- decode_profile -----------------------------------------------------------

def test_decode_profile_buckets_a_cpu_trace(tmp_path):
    """A tiny greedy decode recorded on the CPU: its top-level operators
    fall into decode_profile's buckets, which sum to the operators' time;
    the matmuls, the attention and the cache writes each hold some."""
    cfg = tt5.T5Config.small_test(vocab_size=512)
    params = tt5.init_t5_params(torch.Generator().manual_seed(0), cfg,
                                torch.float32)
    hidden = torch.randn(2, 9, cfg.d_model,
                         generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 9, dtype=torch.int32)
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        from explicit_alignment_for_vqa_tasks_tpu_torch.ops.decoding import (
            greedy_decode_t5,
        )
        greedy_decode_t5(params, cfg, hidden, mask, 3)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ops = decode_profile.device_ops(json.loads(path.read_text()),
                                    ("cpu_op",))
    stats = decode_profile.summarize(ops)
    buckets = stats["buckets_us"]
    assert tuple(buckets) == decode_profile.BUCKETS
    assert stats["summed_us"] == pytest.approx(sum(d for *_, d in ops))
    assert sum(buckets.values()) == pytest.approx(stats["summed_us"])
    assert 0 < stats["busy_us"] <= stats["span_us"]
    assert stats["idle_us"] == pytest.approx(stats["span_us"]
                                             - stats["busy_us"])
    for bucket in ("matmul", "attention", "kv_update", "fusion_elementwise"):
        assert buckets[bucket] > 0, bucket
    assert stats["n_events"] == len(ops)


def test_decode_profile_maps_kernels_to_their_launching_operator():
    """On a card's trace a kernel takes the bucket of the outermost host
    operator of its launch (by "External id", or its runtime call's), else
    of its own name; the idle gap is the span less the busy union."""
    def op(name, ts, dur, ext):
        return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts,
                "dur": dur, "tid": 1, "args": {"External id": ext}}

    def kernel(name, ts, dur, ext=None, corr=None):
        args = {"correlation": corr}
        if ext is not None:
            args["External id"] = ext
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "tid": 7, "args": args}

    trace = {"traceEvents": [
        op("aten::matmul", 0, 50, 1), op("aten::mm", 1, 40, 2),
        op("aten::copy_", 60, 10, 3),
        op("aten::to", 80, 10, 4), op("aten::copy_", 81, 5, 5),
        op("aten::einsum", 100, 10, 6), op("aten::add", 120, 5, 7),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 121, "dur": 1, "tid": 1,
         "args": {"correlation": 99, "External id": 7}},
        kernel("sm90_xmma_gemm_bf16", 200, 30, ext=2),
        kernel("elementwise_kernel<copy>", 240, 4, ext=3),
        kernel("elementwise_kernel<copy>", 250, 6, ext=5),
        kernel("gemv_kernel", 260, 8, ext=6),
        kernel("vectorized_elementwise_kernel<add>", 270, 2, corr=99),
        kernel("cross_attention_decode_kernel", 280, 5),
        kernel("mystery", 290, 10),
    ]}
    ops = decode_profile.device_ops(trace)
    assert [o[1] for o in ops] == ["aten::matmul", "aten::copy_",
                                   "aten::to", "aten::einsum", "aten::add",
                                   "", ""]
    stats = decode_profile.summarize(ops)
    assert stats["buckets_us"] == {
        "matmul": 30, "attention": 8 + 5, "kv_update": 4,
        "fusion_elementwise": 2, "layout": 6, "other": 10}
    assert stats["span_us"] == 100 and stats["busy_us"] == 65
    assert stats["idle_share"] == pytest.approx(0.35)


def test_decode_profile_child_and_report_on_the_cpu(tmp_path, monkeypatch):
    """The tool's child (build, encode, time, trace) and its report at a
    shrunk T0-3B on the CPU: one JSON line whose buckets a step sum to the
    traced operators' time a step."""
    monkeypatch.setattr(tt5.T5Config, "t0_3b", classmethod(
        lambda cls, **kw: cls(**{**dict(vocab_size=512, d_model=64, d_kv=16,
                                        num_heads=4, d_ff=128,
                                        num_encoder_layers=2,
                                        num_decoder_layers=2), **kw})))
    args = decode_profile.parse_args([
        "--batch", "2", "--enc_len", "9", "--steps", "3", "--device", "cpu",
        "--child", str(tmp_path), "--int8_decoder"])
    decode_profile.run_child(args)
    line = decode_profile.report(str(tmp_path), args)
    assert line["config"]["steps_run"] == 3 and line["config"]["int8_decoder"]
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert line["wall_ms_per_step"] > 0
    assert sum(line["per_step_us"].values()) == pytest.approx(
        line["trace"]["summed_us"] / 3)
    assert 0 <= line["idle_share"] < 1
    assert line["busy_share_of_untraced_wall"] > 0
    json.dumps(line)
