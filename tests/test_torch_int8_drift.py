"""The port's int8 drift study (tools/int8_drift_study.py) against the JAX
package's own tool on the CPU. JAX's ``main`` runs at ``--tiny`` for each
mode, and its arrays are recorded as it computes them (its params, each
variant's per-layer encoder states, greedy tokens and log-probs, and its
JSON line). The port's ``run_mode`` runs on the same params.

Every layer is held against JAX, not only the first. An int8 encoder
layer quantizes four activations (the q|k|v input, the attention output,
the FFN input and the FFN hidden); the port's codes of each are compared
with JAX's, taken from the kernels' own expressions under jit as
tests/test_torch_int8_kernels.py takes them:

* teacher-forced: the port's layer l, fed JAX's input to layer l, gives
  JAX's codes and JAX's output within 1e-5 relative; or, where an
  activation lies on a .5 code boundary, exactly one code differs there
  (and what follows it in that layer), and the output is within
  FLIP_LOCAL;
* free-running: the two runs' states stay within 1e-5 of each other up
  to the first layer whose codes differ, where exactly one code differs,
  on a .5 boundary; from there on within FLIP_APART. Each layer's error
  is within 1e-3 relative of JAX's plus that distance.

JAX's JSON line and the port's are then compared field by field."""

import dataclasses
import json
import os
import sys
from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.ops import (  # noqa: E402
    decoding as jdecoding,
)
from explicit_alignment_for_vqa_tasks_tpu.ops import (  # noqa: E402
    fused_attention_block as jfab,
)
from explicit_alignment_for_vqa_tasks_tpu.tools import (  # noqa: E402
    int8_drift_study as jtool,
)
from explicit_alignment_for_vqa_tasks_tpu.utils import (  # noqa: E402
    compilation_cache as jcache,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    fused_attention_block as tfab,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    int8_drift_study,
)
from test_torch_study_tools import CPU, LAYER_REL, to_port  # noqa: E402

STAGES = 4           # activation quantizations in an int8 encoder layer
SAME = 1e-5          # states with equal codes: within this, relative
BOUNDARY = 1e-4      # a flipped code's unrounded value: this near a .5
# (read: 7.6e-6 and 3.8e-6 from it)
FLIP_LOCAL = 5e-3    # one layer's output after one flipped code, relative
# (read: 7.4e-4 after an FFN-input code, 3.2e-4 after a hidden code, and
# 3.3e-3 free-running after a q|k|v code)
FLIP_APART = 1e-2    # the free runs' distance from the flipped layer on
# (read: 3.3e-3 in that layer, 7.0e-3 one layer on)
ROUNDING = 1e-5      # two values each rounded to 5 digits (JAX's line)


def run_jax_tool(monkeypatch, capsys, mode):
    """JAX's ``main`` with ``--tiny --mode <mode>``: its JSON line, and
    {"bf16" and each variant: (params, cfg, per-layer states, tokens,
    log-probs)} as the tool computed them, in its order."""
    encodes, decodes = [], []
    real_encode, real_greedy = jt5.t5_encode, jdecoding.greedy_decode_t5

    def encode(params, cfg, **kw):
        out = real_encode(params, cfg, **kw)
        if kw.get("collect_hiddens"):
            encodes.append((params, cfg, np.asarray(out[1], np.float32)))
        return out

    def greedy(*args, **kw):
        tokens, lps = real_greedy(*args, **kw)
        decodes.append((np.asarray(tokens), np.asarray(lps, np.float32)))
        return tokens, lps

    monkeypatch.setattr(jt5, "t5_encode", encode)
    monkeypatch.setattr(jdecoding, "greedy_decode_t5", greedy)
    # the persistent compilation cache would write outside the checkout
    monkeypatch.setattr(jcache, "enable_compilation_cache",
                        lambda *a, **k: "")
    monkeypatch.setenv("LIBTPU_INIT_ARGS",
                       os.environ.get("LIBTPU_INIT_ARGS", ""))
    monkeypatch.setattr(sys, "argv",
                        ["int8_drift_study", "--tiny", "--mode", mode])
    capsys.readouterr()
    jtool.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    names = ("bf16",) + int8_drift_study.VARIANTS
    assert len(encodes) == len(decodes) == len(names)
    assert list(line[mode]) == list(int8_drift_study.VARIANTS)
    return line, {name: enc + dec
                  for name, enc, dec in zip(names, encodes, decodes)}


@partial(jax.jit, static_argnames=("num_heads", "eps"))
def _jax_layer_codes(x, a8, f8, ln0, ln1, pos_hll, mask, num_heads, eps):
    """JAX's codes of one int8 encoder layer's four quantizations, from
    the input x (B, L, D): the norms and quantizations as the kernels
    write them, q|k|v, the attention and the out-projection through the
    kernels themselves."""
    batch, length, d_model = x.shape

    def norm(x32, w):
        var = jnp.mean(jnp.square(x32), axis=-1, keepdims=True)
        return x32 * jax.lax.rsqrt(var + eps) * w.astype(jnp.float32)

    def quant(h, s):
        return jfab._group_quant_rows_i8(h, jfab._as_group_scales(s).shape[0])

    ln_a = a8["ln"] if "ln" in a8 else ln0
    ln_f = f8["ln"] if "ln" in f8 else ln1
    qkv_in = quant(norm(x.reshape(-1, d_model).astype(jnp.float32), ln_a),
                   a8["q_s"])
    q, k, v = jfab.fused_t5_ln_qkv_q8(x, ln_a, a8["q"], a8["q_s"], a8["k"],
                                      a8["k_s"], a8["v"], a8["v_s"], eps=eps)
    attn = jfab.t5_attention_core_vjp(q, k, v, pos_hll, mask, num_heads)
    o_in = quant(attn.reshape(batch * length, -1).astype(jnp.float32),
                 a8["o_s"])
    y = jfab.fused_oproj_residual_q8(x, attn, a8["o"], a8["o_s"])
    ffn_in = quant(norm(y.reshape(-1, d_model).astype(jnp.float32), ln_f),
                   f8["wi_0_s"])
    hid = jfab._tanh_gelu(jfab._mm_q8_grouped(
        ffn_in, f8["wi_0"], jfab._as_group_scales(f8["wi_0_s"])))
    hid = hid * jfab._mm_q8_grouped(ffn_in, f8["wi_1"],
                                    jfab._as_group_scales(f8["wi_1_s"]))
    return [jnp.concatenate([c for c, _ in parts], axis=1)
            for parts in (qkv_in, o_in, ffn_in, quant(hid, f8["wo_s"]))]


def jax_codes(params, cfg, ids, mask, per_layer):
    """[layer][stage] JAX's codes, each layer fed JAX's own input to it."""
    enc = params["encoder"]
    length = ids.shape[1]
    pos_hll = jt5.compute_position_bias(enc["rel_bias"], length, length,
                                        bidirectional=True, cfg=cfg)[0]
    x = jt5.embed_tokens(params, cfg, ids).astype(cfg.dtype)
    out = []
    for li in range(cfg.num_encoder_layers):
        if li:
            x = jnp.asarray(per_layer[li - 1])
        at = partial(jax.tree.map, lambda a: a[li])
        out.append([np.asarray(c) for c in _jax_layer_codes(
            x, at(enc["self_attn_q8"]), at(enc["ffn_q8"]), enc["ln0"][li],
            enc["ln1"][li], pos_hll, mask, num_heads=cfg.num_heads,
            eps=cfg.layer_norm_epsilon)])
    return out


def port_encode_codes(params, cfg, **kw):
    """The port's t5_encode(collect_hiddens=True) with every activation
    quantization recorded: (per-layer states, [layer][stage] (codes,
    unrounded codes))."""
    record, row_quant = [], tfab._row_quant_i8

    def recording(h):
        q, s = row_quant(h)
        record.append((q.numpy(), (h / s).numpy()))
        return q, s

    tfab._row_quant_i8 = recording
    try:
        _, per_layer = tt5.t5_encode(params, cfg, collect_hiddens=True, **kw)
    finally:
        tfab._row_quant_i8 = row_quant
    # one group at the tiny widths: one quantization a stage
    assert len(record) == STAGES * cfg.num_encoder_layers
    return per_layer.numpy(), [record[li:li + STAGES]
                               for li in range(0, len(record), STAGES)]


def one_layer(params, li):
    """The encoder params cut to layer ``li`` alone."""
    enc = dict(params["encoder"])
    for key in ("self_attn", "ffn", "ffn_q8", "self_attn_q8"):
        enc[key] = {n: v[li:li + 1] for n, v in enc[key].items()}
    for key in ("ln0", "ln1"):
        enc[key] = enc[key][li:li + 1]
    return dict(params, encoder=enc)


def first_flip(port, want):
    """(layer, stage) of the first quantization whose codes differ from
    JAX's, or None. There exactly one code differs, and its unrounded
    value lies within BOUNDARY of a .5 boundary: the two runs rounded an
    activation on the boundary each its own way."""
    for li, (stages, jstages) in enumerate(zip(port, want)):
        for si, ((codes, unrounded), jcodes) in enumerate(
                zip(stages, jstages)):
            differ = codes != jcodes
            if differ.any():
                assert differ.sum() == 1, (li, si, int(differ.sum()))
                t = abs(float(unrounded[differ][0]))
                assert abs(t % 1.0 - 0.5) < BOUNDARY, (li, si, t)
                return li, si
    return None


def assert_layers_match(tparams, tcfg, jrun, ids, mask, jids, jmask):
    """Teacher-forced and free-running, layer by layer (the module's
    docstring); returns the free runs' distance of every layer over the
    norm of JAX's states."""
    jparams, jcfg, jper = jrun[:3]
    want = jax_codes(jparams, jcfg, jids, jmask, jper)
    n_layers = tcfg.num_encoder_layers
    x = jt5.embed_tokens(jparams, jcfg, jids).astype(jnp.float32)
    cfg_one = dataclasses.replace(tcfg, num_encoder_layers=1)
    for li in range(n_layers):
        if li:
            x = jper[li - 1]
        (out,), codes = port_encode_codes(
            one_layer(tparams, li), cfg_one,
            inputs_embeds=torch.as_tensor(np.array(x)), attention_mask=mask)
        local = np.linalg.norm(out - jper[li]) / np.linalg.norm(jper[li])
        bound = SAME if first_flip(codes, want[li:li + 1]) is None \
            else FLIP_LOCAL
        assert local < bound, (li, local)

    per_layer, codes = port_encode_codes(tparams, tcfg, input_ids=ids,
                                         attention_mask=mask)
    flip = first_flip(codes, want)
    apart = np.array([np.linalg.norm(t - j) / np.linalg.norm(j)
                      for t, j in zip(per_layer, jper)])
    flipped = n_layers if flip is None else flip[0]
    assert (apart[:flipped] < SAME).all(), (flip, apart)
    assert (apart[flipped:] < FLIP_APART).all(), (flip, apart)
    return apart


def assert_metrics_match(got: dict, want: dict, apart: np.ndarray):
    """Match rates equal; each layer's error within 1e-3 relative of JAX's
    plus ``apart``, that layer's distance between the two runs (the
    triangle inequality's bound; apart is held by assert_layers_match)."""
    for key in ("full_sequence_match_rate", "mean_first_flip_step"):
        assert got[key] == want[key], key
    err, want_err = (np.asarray(m["per_layer_rel_error"])
                     for m in (got, want))
    assert (np.abs(err - want_err) <= LAYER_REL * want_err + apart).all(), (
        err, want_err, apart)
    # the log-probs follow the last layer: within 1e-3 where the runs'
    # int8 states agree, within a quarter where a flipped code parts them
    np.testing.assert_allclose(
        got["on_trajectory_logprob_mean_abs_diff"],
        want["on_trajectory_logprob_mean_abs_diff"],
        rtol=LAYER_REL if apart.max() < SAME else 0.25, atol=1e-6)


def assert_line_matches(port: dict, jline: dict, apart: np.ndarray):
    """A variant's entry of the port's JSON line against JAX's, field by
    field: JAX's fields (the port adds per_layer_rel_error), the match
    rates equal, the errors as assert_metrics_match holds them plus the
    two lines' rounding."""
    assert set(port) - {"per_layer_rel_error"} == set(jline)
    for key in ("full_sequence_match_rate", "mean_first_flip_step"):
        assert port[key] == jline[key], key
    tol = {}
    for key, li in (("first_layer_rel_error", 0),
                    ("last_layer_rel_error", -1)):
        tol[key] = LAYER_REL * jline[key] + apart[li] + ROUNDING
        assert abs(port[key] - jline[key]) <= tol[key], (key, port, jline)
    growth = jline["growth_factor"]
    assert abs(port["growth_factor"] - growth) <= 0.01 + growth * sum(
        tol[k] / jline[k] for k in tol), (port, jline)
    key = "on_trajectory_logprob_mean_abs_diff"
    rel = LAYER_REL if apart.max() < SAME else 0.25
    assert abs(port[key] - jline[key]) <= rel * jline[key] + ROUNDING, key


@pytest.mark.parametrize("mode", ["normal", "outlier"])
def test_int8_drift_tiny_matches_jax(mode, monkeypatch, capsys):
    """--tiny's config and inputs on the params of JAX's tool (JAX's
    init_t5_params(PRNGKey(0))): the outlier norms bit-equal to JAX's, the
    per-channel and grouped int8 weight codes and scales bit-equal, every
    variant's greedy tokens equal, every layer held against JAX
    (assert_layers_match), the per-layer errors within 1e-3 relative of
    JAX's plus the runs' distance, and the port's JSON line equal to JAX's
    tool's field by field within those bounds."""
    jline, jruns = run_jax_tool(monkeypatch, capsys, mode)
    tiny = int8_drift_study.TINY
    jcfg = jt5.T5Config(**tiny, dtype=jnp.float32,
                        fused_encoder_attention=True)
    tcfg = tt5.T5Config(**tiny, dtype=torch.float32,
                        fused_encoder_attention=True)
    assert jruns["bf16"][1] == jcfg
    shapes = jline["shapes"]
    batch, length = shapes["batch"], shapes["enc_len"]
    max_new = shapes["max_new_tokens"]
    tp = to_port(jt5.init_t5_params(jax.random.PRNGKey(0), jcfg,
                                     jnp.bfloat16), torch.bfloat16)
    if mode == "outlier":
        tp = int8_drift_study.with_outlier_norms(tp)
    jp = jruns["bf16"][0]
    for name in ("ln0", "ln1"):
        np.testing.assert_array_equal(
            tp["encoder"][name].float().numpy(),
            np.asarray(jp["encoder"][name], np.float32))
    ids, mask = int8_drift_study.study_inputs(tcfg, batch, length, CPU)
    # JAX's draw (tools/int8_drift_study.py: np.random.default_rng(0))
    rng = np.random.default_rng(0)
    jids = jnp.asarray(rng.integers(2, min(32000, jcfg.vocab_size - 8),
                                    (batch, length)), jnp.int32)
    jmask = jnp.ones((batch, length), jnp.int32)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))

    tvars = int8_drift_study.quantized_variants(tp, tcfg, ids, mask)
    assert list(tvars) == list(int8_drift_study.VARIANTS)
    for name, (tq, _) in tvars.items():
        for key in ("ffn_q8", "self_attn_q8"):
            want = jruns[name][0]["encoder"][key]
            assert sorted(tq["encoder"][key]) == sorted(want)
            for leaf, w in want.items():
                got, w = tq["encoder"][key][leaf], np.asarray(w)
                if "smooth" not in name and name != "full_stack":
                    np.testing.assert_array_equal(
                        got.float().numpy(), w.astype(np.float32),
                        err_msg=f"{name} {leaf}")
                elif w.dtype == np.int8:
                    # SmoothQuant folds maxima calibrated through the
                    # encoder, within 1e-5 of JAX's (as in
                    # tests/test_torch_int8_encoder.py): a code may sit
                    # one step off where its factor differs in an ulp
                    diff = np.abs(got.numpy().astype(np.int32)
                                  - w.astype(np.int32))
                    assert diff.max() <= 1 and diff.mean() < 1e-3, leaf
                else:
                    np.testing.assert_allclose(
                        got.float().numpy(), w.astype(np.float32),
                        rtol=1e-5, err_msg=f"{name} {leaf}")

    got = int8_drift_study.run_mode(tp, tcfg, ids, mask, max_new)
    ref = jruns["bf16"][2:]
    tref = int8_drift_study.encode_and_decode(tp, tcfg, ids, mask, max_new)
    assert np.linalg.norm(tref[0] - ref[0]) <= SAME * np.linalg.norm(ref[0])
    np.testing.assert_array_equal(tref[1], ref[1])
    for name, (tq, cfg_v) in tvars.items():
        jout = jruns[name][2:]
        tout = int8_drift_study.encode_and_decode(tq, cfg_v, ids, mask,
                                                  max_new)
        np.testing.assert_array_equal(tout[1], jout[1], err_msg=name)
        apart = assert_layers_match(tq, cfg_v, jruns[name], ids, mask,
                                    jids, jmask)
        assert_metrics_match(got[name],
                             int8_drift_study.drift_metrics(ref, jout,
                                                            max_new), apart)
        assert_line_matches(int8_drift_study.rounded(got[name]),
                            jline[mode][name], apart)

    line = int8_drift_study.main(["--tiny", "--mode", mode], device="cpu")
    for key in ("metric", "modes", "shapes"):
        assert line[key] == jline[key], key
    assert list(line[mode]) == list(jline[mode])


def test_int8_drift_cli_tiny_prints_both_modes(capsys):
    line = int8_drift_study.main(["--tiny", "--mode", "both"], device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(line))
    assert line["shapes"]["tiny"] is True
    for mode in ("normal", "outlier"):
        assert set(line[mode]) == set(int8_drift_study.VARIANTS)
        for metrics in line[mode].values():
            assert 0.0 <= metrics["full_sequence_match_rate"] <= 1.0
            assert len(metrics["per_layer_rel_error"]) == 3
            assert metrics["last_layer_rel_error"] > 0.0
