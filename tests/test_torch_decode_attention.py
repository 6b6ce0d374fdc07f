"""The port's decode-step cross-attention (ops/decode_attention.py): the
plain version against the JAX package's Pallas kernel (interpret mode on
the CPU), the wrapper on CPU tensors, greedy decoding with
fused_decode_attention against the JAX package's, and the CUDA kernel
against the plain version on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch import kernels
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.decode_attention import (
    cross_attention_decode,
    cross_attention_decode_plain,
)

LAYERS, BATCH, LENC, HEADS, DH = 3, 2, 11, 4, 16
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32: the two sides sum the scores and PV in other orders. bf16: the
# probabilities are rounded to bf16 on both sides in the same order, so an
# output differs by at most about one bf16 ulp (outputs are below 4).
TOLERANCE = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=8e-3, atol=1.6e-2)}


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    width = HEADS * DH
    q = rng.standard_normal((BATCH, width)).astype(np.float32)
    k, v = (rng.standard_normal((LAYERS, BATCH, LENC, width))
            .astype(np.float32) for _ in range(2))
    mask = np.ones((BATCH, LENC), np.int32)
    mask[0, -3:] = 0
    mask[1, 2] = 0                     # a masked key inside the row
    return q, k, v, mask


def run_jax(q, k, v, mask, layer, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from explicit_alignment_for_vqa_tasks_tpu.ops.decode_attention import (
        cross_attention_decode as jax_cross_attention_decode,
    )

    jd = getattr(jnp, dtype)
    out = jax_cross_attention_decode(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(mask), jnp.int32(layer), HEADS, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def run_port(fn, q, k, v, mask, layer, dtype):
    td = TORCH_DTYPES[dtype]
    out = fn(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
             torch.from_numpy(v).to(td), torch.from_numpy(mask), layer, HEADS)
    assert out.dtype == td and tuple(out.shape) == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("layer", range(LAYERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(dtype, layer):
    inputs = make_inputs()
    want = run_jax(*inputs, layer, dtype)
    got = run_port(cross_attention_decode_plain, *inputs, layer, dtype)
    np.testing.assert_allclose(got, want, **TOLERANCE[dtype])


def test_wrapper_takes_plain_version_on_cpu():
    inputs = make_inputs(seed=1)
    before = cross_attention_decode.launches
    got = run_port(cross_attention_decode, *inputs, 2, "bfloat16")
    want = run_port(cross_attention_decode_plain, *inputs, 2, "bfloat16")
    np.testing.assert_array_equal(got, want)
    assert cross_attention_decode.launches == before


def test_library_path_is_keyed_by_source_hash():
    path = kernels.library_path("cross_attention_decode")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("cross_attention_decode-")
    assert kernels.SOURCES["cross_attention_decode"] == \
        "cross_attention_decode.cu"


# --- the decode step with fused_decode_attention, against JAX's -------------

def model_configs(**kw):
    """The JAX package's tests/test_decode_attention.py configuration."""
    jt5 = pytest.importorskip("explicit_alignment_for_vqa_tasks_tpu.models.t5")
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5

    base = dict(vocab_size=256, d_model=64, d_kv=16, num_heads=4, d_ff=128,
                num_encoder_layers=2, num_decoder_layers=3,
                relative_attention_num_buckets=8,
                relative_attention_max_distance=16)
    import jax.numpy as jnp

    return (jt5.T5Config(**base, dtype=jnp.float32, **kw),
            tt5.T5Config(**base, dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def model():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5
    from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (
        t5_params_from_numpy,
    )

    jcfg, _ = model_configs()
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jp, t5_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    torch.float32, "cpu")


@pytest.mark.parametrize("pad", [0, 4])
def test_greedy_decode_with_fused_attention_matches_jax(model, pad):
    """As tests/test_decode_attention.py:68-85 holds the JAX kernel to the
    XLA step: the port's fused greedy decode against JAX's fused one on
    the same encoder states: equal tokens, log-probs within rtol 1e-4 /
    atol 1e-5."""
    import jax.numpy as jnp
    from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5
    from explicit_alignment_for_vqa_tasks_tpu.ops.decoding import (
        greedy_decode_t5 as jax_greedy,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.ops.decoding import (
        greedy_decode_t5,
    )

    jp, tp = model
    jcfg, tcfg = model_configs(fused_decode_attention=True)
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 250, (3, 9)).astype(np.int32)
    mask = np.ones((3, 9), dtype=np.int32)
    if pad:
        mask[1, -pad:] = 0
    hidden = np.asarray(jt5.t5_encode(jp, dataclasses.replace(
        jcfg, fused_decode_attention=False), input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask)))
    want_tok, want_lp = jax_greedy(jp, jcfg, jnp.asarray(hidden),
                                   jnp.asarray(mask), 6)
    before = cross_attention_decode.launches
    got_tok, got_lp = greedy_decode_t5(tp, tcfg, torch.from_numpy(hidden),
                                       torch.from_numpy(mask), 6)
    assert cross_attention_decode.launches == before   # CPU: plain version
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               rtol=1e-4, atol=1e-5)


def test_fused_with_int8_cross_kv_raises_as_jax_does(model):
    import jax.numpy as jnp
    from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5

    jp, tp = model
    jcfg, tcfg = model_configs(fused_decode_attention=True,
                               int8_cross_kv=True)
    hidden = np.zeros((2, 5, 64), np.float32)
    mask = np.ones((2, 5), np.int32)
    token = np.zeros((2,), np.int32)
    jcache = jt5.init_decode_cache(jp, jcfg, jnp.asarray(hidden), 4)
    with pytest.raises(ValueError, match="disable fused_decode_attention"):
        jt5.t5_decode_step(jp, jcfg, jnp.asarray(token), jcache,
                           jnp.asarray(mask))
    tcache = tt5.init_decode_cache(tp, tcfg, torch.from_numpy(hidden), 4)
    with pytest.raises(ValueError, match="disable fused_decode_attention"):
        tt5.t5_decode_step(tp, tcfg, torch.from_numpy(token), tcache,
                           torch.from_numpy(mask))


# --- on the card: the CUDA kernel against the plain version ----------------

@pytest.mark.gpu
@pytest.mark.parametrize("layers,batch,length,heads,head_dim,layer", [
    (24, 4, 557, 32, 64, 7),    # the main path's widths on a few rows
    (3, 3, 37, 3, 16, 2),
    (2, 2, 130, 5, 128, 0),
    (2, 2, 13000, 4, 32, 1),    # a score row past 48 KB of shared memory
])
def test_cuda_kernel_matches_plain_version(layers, batch, length, heads,
                                           head_dim, layer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    width = heads * head_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    q = randn(batch, width)
    k, v = randn(layers, batch, length, width), randn(layers, batch, length,
                                                       width)
    mask = torch.ones((batch, length), dtype=torch.int32, device="cuda")
    mask[0, -length // 5:] = 0
    mask[batch - 1] = 0                 # a fully masked row: the mean of v
    before = cross_attention_decode.launches
    got = cross_attention_decode(q, k, v, mask, layer, heads)
    torch.cuda.synchronize()
    assert cross_attention_decode.launches == before + 1
    want = cross_attention_decode_plain(q, k, v, mask, layer, heads)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=8e-3)
    with pytest.raises(ValueError, match="bfloat16"):
        cross_attention_decode(q.float(), k, v, mask, layer, heads)
    with pytest.raises(ValueError, match="outside"):
        cross_attention_decode(q, k, v, mask, layers, heads)
