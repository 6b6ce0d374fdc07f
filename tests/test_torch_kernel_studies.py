"""The port's kernel studies against the JAX package's on the CPU: the
train step's FLOP model (exactly), train_step_study at --tiny (JAX's
sections; its first loss against JAX's vct0_caption_loss on carried
weights), the ViT studies' tables against the JAX files' (read with ast,
since they are local to JAX's main), their towers' layer functions against
the JAX towers' (Pallas in interpret mode) and their FLOP splits."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import clip as jclip  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import mappers as jmappers  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import vct0 as jvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.ops import (  # noqa: E402
    fused_attention_block as jfab,
)
from explicit_alignment_for_vqa_tasks_tpu.tools import (  # noqa: E402
    train_step_study as jstudy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    clip_vision_params_from_numpy,
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    train_step_study,
    vit_b_study,
    vit_l_study,
    vit_studies,
)

JAX_TOOLS = (pathlib.Path(__file__).resolve().parents[1]
             / "explicit_alignment_for_vqa_tasks_tpu" / "tools")
LOSS_RTOL = 1e-5     # the same fp32 loss on the same weights and inputs
# a tower layer's bf16 output against JAX's on the same input: within two
# bf16 ulps of |want| + rms(want) (one rounding each side of a product or
# a softmax sum), and at least MIN_EQUAL of the elements bit-equal
BF16_ULP = 2.0 ** -7
MIN_EQUAL = 0.99
EPS = 1e-5


@pytest.mark.parametrize("cfg_name", ["small_test", "t0_3b"])
@pytest.mark.parametrize("enc_len,dec_len", [(10, 32), (8, 16), (2, 5)])
@pytest.mark.parametrize("with_dw", [False, True])
def test_train_flops_equal_jax(cfg_name, enc_len, dec_len, with_dw):
    got = train_step_study.t5_train_flops_per_example(
        getattr(tt5.T5Config, cfg_name)(), enc_len, dec_len, with_dw)
    want = jstudy.t5_train_flops_per_example(
        getattr(jt5.T5Config, cfg_name)(), enc_len, dec_len, with_dw)
    assert got == want


# the JAX study's output keys (tools/train_step_study.py:214-219, :265-279;
# its config's ceiling_tflops is the port's measured_ceiling_tflops)
JAX_SECTIONS = {"metric", "config", "batch_sweep", "variants",
                "int8_forward_bound"}
JAX_POINT_KEYS = {"ms_per_step", "examples_per_s",
                  "analytic_gflop_per_example", "achieved_tflops_per_s",
                  "pct_of_measured_ceiling"}
JAX_CONFIG_KEYS = {"caption_len", "prefix_length", "steps_per_fetch", "tiny"}


def test_tiny_study_emits_jax_sections_and_jax_loss():
    """--tiny on the CPU: JAX's sections, keys and bound fields; the first
    step's loss equals JAX's on the same weights. No timing order is
    asserted: a loaded host can invert any."""
    args = train_step_study.build_parser().parse_args(
        ["--tiny", "--device", "cpu", "--batches", "4,2", "--steps", "2",
         "--trials", "1"])
    jlm = dataclasses.replace(jt5.T5Config.small_test(num_heads=4, d_ff=64),
                              dtype=jnp.float32)
    jcfg = jvct0.VCT0Config(lm=jlm, mapper=jmappers.MapperConfig(
        prefix_size=16, d_model=jlm.d_model, prefix_length=2,
        clip_length=2))
    jparams = jvct0.init_vct0_params(jax.random.PRNGKey(0), jcfg,
                                     param_dtype=jnp.float32)
    tparams = vct0_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     torch.float32, "cpu")
    out = train_step_study.study(args, device="cpu", params=tparams)
    assert JAX_SECTIONS <= set(out)
    assert JAX_CONFIG_KEYS <= set(out["config"])
    assert out["config"]["tiny"] is True
    assert out["config"]["measured_ceiling_tflops"] is None   # no card
    assert set(out["batch_sweep"]) == {"4", "2"}
    assert set(out["variants"]) == set(train_step_study.VARIANTS)
    for point in [*out["batch_sweep"].values(), *out["variants"].values()]:
        assert JAX_POINT_KEYS <= set(point), point
        assert point["ms_per_step"] > 0
    assert "step_over_fwd_ratio" in out["variants"]["fwd"]
    assert {"assumption", "max_step_speedup", "max_saved_ms"} <= set(
        out["int8_forward_bound"])
    rng = np.random.default_rng(0)
    clip = rng.standard_normal((4, 16)).astype(np.float32)
    labels = rng.integers(2, jlm.vocab_size - 100, size=(4, 32)).astype(
        np.int32)
    want = float(jvct0.vct0_caption_loss(
        jparams["mapper"], jparams["lm"], jcfg, jnp.asarray(clip),
        jnp.asarray(labels)))
    for point in (out["batch_sweep"]["4"], out["variants"]["remat"],
                  out["variants"]["fwd"]):
        assert point["first_loss"] == pytest.approx(want, rel=LOSS_RTOL)
    assert np.isfinite(out["variants"]["base"]["final_loss"])


def jax_dict_keys(path, name):
    """The keys of the dict literal assigned to ``name`` in ``path``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets):
            return [ast.literal_eval(k) for k in node.value.keys]
    raise AssertionError(f"no {name} = {{...}} in {path}")


@pytest.mark.parametrize("module,jax_file", [
    (vit_b_study, "vit_b_study.py"), (vit_l_study, "vit_l_study.py")])
def test_vit_tables_hold_jax_keys(module, jax_file):
    path = JAX_TOOLS / jax_file
    for table, name in ((module.VARIANTS, "variants"),
                        (module.TOWERS, "towers")):
        assert list(table) == jax_dict_keys(path, name)
        for key, spec in table.items():
            if isinstance(spec, str):   # a same_program_as target is timed
                assert not isinstance(table[spec], str), key
    fns = vit_studies.layer_functions(4, 64, EPS)
    for spec in module.TOWERS.values():
        if not isinstance(spec, str):
            assert spec[0] in fns
            assert set(spec[1]) <= {"qkv", "scores_pv", "o_proj", "mlp"}


@pytest.mark.parametrize("jax_file", ["vit_b_study.py", "vit_l_study.py"])
def test_flop_split_equals_jax(jax_file):
    """JAX's per_layer dict literal evaluated at the port's shapes."""
    tree = ast.parse((JAX_TOOLS / jax_file).read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "per_layer"
                        for t in n.targets))
    expr = ast.Expression(node.value)
    for L, D, FF in ((50, 768, 3072), (577, 1024, 4096), (197, 64, 256)):
        want = eval(compile(expr, jax_file, "eval"),
                    {"L": L, "D": D, "FF": FF})
        assert vit_studies.flop_split(L, D, FF) == want


def jax_layer_functions(num_heads, width, eps):
    """The JAX studies' tower layer functions (vit_b_study.py:160-231,
    vit_l_study.py:142-208) over the JAX kernels; group 1 (the group
    changes no value)."""
    head_dim = width // num_heads
    dt_bf = jnp.bfloat16

    def einsum(x, w):
        return jnp.einsum("bld,de->ble", x, w.astype(dt_bf),
                          preferred_element_type=jnp.float32).astype(dt_bf)

    def qkv_projections_xla(x, lp):
        ln1 = jclip._layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
        q, k, v = (einsum(ln1, lp[n]) for n in ("q", "k", "v"))
        return (q + k + v).astype(dt_bf)

    def whole_block(x, lp):
        return jfab.fused_vit_block(
            x, lp["ln1_scale"], lp["ln1_bias"], lp["q"], lp["q_bias"],
            lp["k"], lp["k_bias"], lp["v"], lp["v_bias"], lp["o"],
            lp["o_bias"], lp["ln2_scale"], lp["ln2_bias"], lp["mlp_fc"],
            lp["mlp_fc_bias"], lp["mlp_proj"], lp["mlp_proj_bias"],
            num_heads=num_heads, group=1, eps=eps)

    def ln_qkv_fused(x, lp):
        q, k, v = jfab.fused_ln_qkv(
            x, lp["ln1_scale"], lp["ln1_bias"], lp["q"], lp["q_bias"],
            lp["k"], lp["k_bias"], lp["v"], lp["v_bias"],
            scale=head_dim ** -0.5, group=1, eps=eps)
        return (q + k + v).astype(dt_bf)

    def attention_core(x, lp, fast_exp=False):
        return jfab.attention_core(x * (head_dim ** -0.5), x, x, num_heads,
                                   group=1, fast_exp=fast_exp).astype(dt_bf)

    def core_oproj(x, lp):
        return jfab.attention_core_oproj(
            x, x * (head_dim ** -0.5), x, x, lp["o"], lp["o_bias"],
            num_heads=num_heads, group=1)

    def mlp_fused(x, lp):
        return jfab.fused_mlp_block(
            x, lp["ln2_scale"], lp["ln2_bias"], lp["mlp_fc"],
            lp["mlp_fc_bias"], lp["mlp_proj"], lp["mlp_proj_bias"],
            group=1, eps=eps)

    def attn_half_split(x, lp):
        ln1 = jclip._layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
        q, k, v = (einsum(ln1, lp[n]) + lp[n + "_bias"].astype(dt_bf)
                   for n in ("q", "k", "v"))
        attn = jfab.attention_core(q * (head_dim ** -0.5), k, v, num_heads,
                                   group=1)
        return x + einsum(attn, lp["o"]) + lp["o_bias"].astype(dt_bf)

    def attn_half_split3(x, lp):
        q, k, v = jfab.fused_ln_qkv(
            x, lp["ln1_scale"], lp["ln1_bias"], lp["q"], lp["q_bias"],
            lp["k"], lp["k_bias"], lp["v"], lp["v_bias"],
            scale=head_dim ** -0.5, group=1, eps=eps)
        return jfab.attention_core_oproj(x, q, k, v, lp["o"], lp["o_bias"],
                                         num_heads=num_heads, group=1)

    return dict(
        qkv_projections_xla=qkv_projections_xla, whole_block=whole_block,
        ln_qkv_fused=ln_qkv_fused, attention_core=attention_core,
        attention_core_fast_exp=lambda x, lp: attention_core(x, lp, True),
        core_oproj=core_oproj, mlp_fused=mlp_fused,
        attn_half_split=attn_half_split, attn_half_split3=attn_half_split3)


@pytest.fixture(scope="module")
def tower_params():
    """Two layers at width 64, 4 heads, d_ff 256, bf16, in both packages."""
    cfg = jclip.CLIPVisionConfig.small_test(width=64, num_heads=4,
                                            num_layers=2, dtype=jnp.bfloat16)
    jparams = jclip.init_clip_vision_params(jax.random.PRNGKey(0), cfg,
                                            jnp.bfloat16)
    tparams = clip_vision_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
        torch.bfloat16, "cpu")
    return jparams["blocks"], tparams["blocks"]


@pytest.mark.parametrize("fn_name,seq", [
    ("whole_block", 50), ("qkv_projections_xla", 50), ("ln_qkv_fused", 50),
    ("attention_core", 50), ("core_oproj", 50), ("mlp_fused", 50),
    ("attn_half_split", 197), ("attn_half_split3", 197),
    ("attention_core", 197), ("attention_core_fast_exp", 197),
    ("mlp_fused", 197)])
def test_tower_layers_match_jax(tower_params, fn_name, seq):
    """Each layer of a 2-layer tower on the same bf16 input (JAX's output
    of the layer before) in both packages."""
    jblocks, tblocks = tower_params
    jfn = jax_layer_functions(4, 64, EPS)[fn_name]
    tfn = vit_studies.layer_functions(4, 64, EPS)[fn_name]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((4, seq, 64)), jnp.bfloat16)
    for i in range(2):
        jlp = {k: v[i] for k, v in jblocks.items()}
        tlp = {k: v[i] for k, v in tblocks.items()}
        want = np.asarray(jfn(x, jlp), np.float32)
        got = tfn(torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
                  tlp).float().numpy()
        assert got.shape == want.shape
        bound = 2 * BF16_ULP * (np.abs(want) + np.sqrt(np.mean(want ** 2)))
        assert np.all(np.abs(got - want) <= bound), (fn_name, i)
        assert np.mean(got == want) >= MIN_EQUAL, (fn_name, i)
        x = jnp.asarray(want, jnp.bfloat16)


@pytest.mark.parametrize("rate,saved,speedup", [
    (2.0, 25.0, 100.0 / 75.0), (1.0, 0.0, 1.0), (0.5, 0.0, 1.0),
    (None, None, None)])
def test_int8_forward_bound(rate, saved, speedup):
    """A 100 ms step with a 50 ms forward: int8 at ``rate`` times bf16
    saves (1 - 1/rate) of the forward at most, nothing where it is not
    faster, and nothing is claimed without a measured rate."""
    out = train_step_study.int8_forward_bound(100.0, 50.0, rate)
    assert out["int8_over_bf16_rate"] == rate
    assert out["max_saved_ms"] == saved
    assert out["max_step_speedup"] == (None if speedup is None
                                       else pytest.approx(speedup))
