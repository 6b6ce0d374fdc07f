"""The port's captioning loss, vct0_caption_loss, against the JAX
package's on the same VC-T0 (weights carried with convert.py), on the CPU
at small widths: the loss and the mapper's gradient through the unfused
encoder and the attention + FFN kernels' route (their plain versions
forward, their twins backward), with and without remat, fp32 and bf16;
remat changes no gradient; the frozen LM gets none. The tolerances are
tests/test_torch_t5_loss.py's."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import mappers as jmappers  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import vct0 as jvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import mappers as tmappers  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import vct0 as tvct0  # noqa: E402
from test_torch_t5_loss import (  # noqa: E402
    BATCH,
    BF16_COSINE,
    GRAD_RTOL,
    JAX_DTYPES,
    LOSS_REL,
    ROUTES,
    TORCH_DTYPES,
    assert_grad_close,
    configs,
    labels,
)

PREFIX_SIZE, PREFIX_LENGTH = 16, 3


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return (a @ b) / np.sqrt((a @ a) * (b @ b))


def vct0_pair(dtype, route, remat):
    """The same VC-T0 (LM in ``dtype``, fp32 mapper) in both packages."""
    jcfg, tcfg = configs(dtype, remat=remat, **ROUTES[route])
    mapper = dict(prefix_size=PREFIX_SIZE, d_model=64,
                  prefix_length=PREFIX_LENGTH, clip_length=PREFIX_LENGTH)
    jv = jvct0.VCT0Config(lm=jcfg, mapper=jmappers.MapperConfig(**mapper))
    tv = tvct0.VCT0Config(lm=tcfg, mapper=tmappers.MapperConfig(**mapper))
    jparams = jvct0.init_vct0_params(jax.random.PRNGKey(5), jv,
                                     param_dtype=JAX_DTYPES[dtype])
    tparams = vct0_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     TORCH_DTYPES[dtype], "cpu")
    return jv, tv, jparams, tparams


@pytest.mark.parametrize("dtype,route,remat", [
    ("float32", "unfused", False), ("float32", "unfused", True),
    ("float32", "attention_ffn", False), ("float32", "attention_ffn", True),
    # remat's bf16 run repeats the same bf16 arithmetic
    # (test_remat_changes_no_gradient)
    ("bfloat16", "unfused", False), ("bfloat16", "attention_ffn", False)])
def test_vct0_caption_loss_and_mapper_grad_match_jax(dtype, route, remat):
    jv, tv, jparams, tparams = vct0_pair(dtype, route, remat)
    rng = np.random.default_rng(6)
    clip = rng.standard_normal((BATCH, PREFIX_SIZE)).astype(np.float32)
    ids = labels(7)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda m: jvct0.vct0_caption_loss(m, jparams["lm"], jv,
                                          jnp.asarray(clip),
                                          jnp.asarray(ids))))(
        jparams["mapper"])
    mapper = {name: {k: t.requires_grad_() for k, t in layer.items()}
              for name, layer in tparams["mapper"].items()}
    tloss = tvct0.vct0_caption_loss(mapper, tparams["lm"], tv,
                                    torch.from_numpy(clip),
                                    torch.from_numpy(ids))
    tloss.backward()
    assert all(not t.requires_grad for t in jax.tree.leaves(
        tparams["lm"], is_leaf=torch.is_tensor))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=LOSS_REL[dtype])
    for name, layer in mapper.items():
        for key, tensor in layer.items():
            want = np.asarray(jgrads[name][key])
            if dtype == "bfloat16":
                assert cosine(tensor.grad.numpy(), want) >= BF16_COSINE
            else:
                assert_grad_close(tensor.grad.numpy(), want,
                                  GRAD_RTOL if route == "unfused"
                                  else 2.0 ** -8)


def test_remat_changes_no_gradient():
    """The same loss and mapper gradient with and without remat (the port
    against itself, bit for bit: the recompute repeats the same
    arithmetic)."""
    grads = []
    for remat in (False, True):
        _, tv, _, tparams = vct0_pair("float32", "attention_ffn", remat)
        mapper = {name: {k: t.requires_grad_() for k, t in layer.items()}
                  for name, layer in tparams["mapper"].items()}
        loss = tvct0.vct0_caption_loss(
            mapper, tparams["lm"], tv,
            torch.ones((BATCH, PREFIX_SIZE)), torch.from_numpy(labels(8)))
        loss.backward()
        grads.append((float(loss), mapper["fc2"]["w"].grad.clone()))
    assert grads[0][0] == grads[1][0]
    assert torch.equal(grads[0][1], grads[1][1])


def test_frozen_lm_gets_no_gradient():
    _, tv, _, tparams = vct0_pair("float32", "unfused", False)
    lm = tparams["lm"]
    lm["shared"].requires_grad_()
    mapper = {name: {k: t.requires_grad_() for k, t in layer.items()}
              for name, layer in tparams["mapper"].items()}
    tvct0.vct0_caption_loss(mapper, lm, tv, torch.ones((1, PREFIX_SIZE)),
                            torch.from_numpy(labels()[:1])).backward()
    assert lm["shared"].grad is None
    unfrozen = dataclasses.replace(tv, freeze_lm=False)
    tvct0.vct0_caption_loss(mapper, lm, unfrozen,
                            torch.ones((1, PREFIX_SIZE)),
                            torch.from_numpy(labels()[:1])).backward()
    assert lm["shared"].grad is not None
