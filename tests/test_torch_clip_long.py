"""The port's long-sequence CLIP variants that run the attention core
kernel against the JAX package's on the seq197 tower of
tests/test_torch_clip.py: the four split* blocks and the legacy
fused_attention (Pallas in interpret mode on the JAX side, the kernels'
plain versions on the port's)."""

import pytest

pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    fused_attention_block as tfab,
)
from test_torch_clip import (  # noqa: E402,F401
    CROSS_PATH_COSINE,
    SAME_PATH_COSINE,
    cosine,
    encode_jax,
    encode_port,
    towers,
)

# the long-sequence variants that run the attention core kernel: the four
# split* blocks (fused_mlp_block after it; split_c2 only splits that
# program's rows for the TPU scheduler, so JAX's chunked result holds the
# port's unchunked one) and the legacy fused_attention (XLA's MLP after it)
LONG_VARIANTS = [dict(fused_block=True, fused_block_long=name)
                 for name in ("split", "split_c2", "split_fe", "split_c2fe")
                 ] + [dict(fused_attention=True)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kw", LONG_VARIANTS,
                         ids=[k.get("fused_block_long", "fused_attention")
                              for k in LONG_VARIANTS])
def test_long_variants_match_jax_same_path(towers, kw, dtype):
    """Held within the split3 tolerances: per-row cosine to JAX's same
    path, and to JAX's default path."""
    names = ("attention_core", "fused_mlp_block")
    launches = [getattr(tfab, n).launches for n in names]
    got = encode_port(towers, "seq197", dtype, **kw)
    # CPU tensors: the kernels' plain versions, no launch
    assert launches == [getattr(tfab, n).launches for n in names]
    want = encode_jax(towers, "seq197", dtype, **kw)
    cos = cosine(got, want)
    assert (cos >= SAME_PATH_COSINE).all(), cos
    cross = cosine(got, encode_jax(towers, "seq197", dtype))
    assert (cross > CROSS_PATH_COSINE).all(), cross
