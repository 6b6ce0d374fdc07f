"""The port's checkpoint converters against the JAX package on the CPU:
``mapper_params_from_reference_ckpt`` gives JAX's trees bit for bit (mlp
and transformer); ``tools/convert_reference_checkpoint.py`` writes a port
checkpoint holding JAX's converted mapper; ``tools/convert_orbax_checkpoint``
reads a JAX Orbax checkpoint with tensorstore alone (no jax) into the
port's files, its mapper and the optax state's moments, accumulated
gradient and counts bit-equal, and an optimizer resumed from it goes on as
the JAX run does. (tests/test_torch_eval_cli.py runs ``main --mode test``
from both converters' checkpoints.)"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import (  # noqa: E402
    hf_convert as jconvert,
)
from explicit_alignment_for_vqa_tasks_tpu.tools import (  # noqa: E402
    convert_reference_checkpoint as jref,
)
from explicit_alignment_for_vqa_tasks_tpu.trainers import (  # noqa: E402
    checkpointing as jckpt,
    optimization as jopt,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import (  # noqa: E402
    hf_convert as tconvert,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models.mappers import (  # noqa: E402
    MapperConfig,
    mapper_apply,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    convert_orbax_checkpoint as torbax,
    convert_reference_checkpoint as tref,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (  # noqa: E402
    checkpointing as tckpt,
    optimization as topt,
)
from test_torch_optimization import (  # noqa: E402
    PARAM_REL,
    TOTAL_STEPS,
    config,
    params_and_grads,
    port_tree,
    run_port,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX_SIZE, D_MODEL, N_PREFIX, LAYERS = 16, 32, 4, 2


def reference_state_dict(mapping_type, seed=0):
    """A reference LightningModule state dict's mapper (``model.`` prefix,
    torch Linear (out, in) weights), beside an LM weight it ignores."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    sd = {"model.lm.shared.weight": rand(5, 3)}

    def linear(name, n_in, n_out, bias=True):
        sd[f"model.clip_project.{name}.weight"] = rand(n_out, n_in)
        if bias:
            sd[f"model.clip_project.{name}.bias"] = rand(n_out)

    if mapping_type == "mlp":
        hidden = D_MODEL * N_PREFIX // 2
        linear("model.0", PREFIX_SIZE, hidden)
        linear("model.2", hidden, D_MODEL * N_PREFIX)
        return sd
    linear("linear", PREFIX_SIZE, N_PREFIX * D_MODEL)
    sd["model.clip_project.prefix_const"] = rand(N_PREFIX, D_MODEL)
    for i in range(LAYERS):
        base = f"transformer.layers.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"model.clip_project.{base}.{norm}.weight"] = rand(D_MODEL)
            sd[f"model.clip_project.{base}.{norm}.bias"] = rand(D_MODEL)
        # the reference's attention projections have no bias
        linear(f"{base}.attn.to_queries", D_MODEL, D_MODEL, bias=False)
        linear(f"{base}.attn.to_keys_values", D_MODEL, 2 * D_MODEL,
               bias=False)
        linear(f"{base}.attn.project", D_MODEL, D_MODEL)
        linear(f"{base}.mlp.fc1", D_MODEL, 2 * D_MODEL)
        linear(f"{base}.mlp.fc2", 2 * D_MODEL, D_MODEL)
    return sd


def assert_trees_bit_equal(got, want):
    assert isinstance(got, dict) and sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, dict):
            assert_trees_bit_equal(got[key], value)
        else:
            got_np = np.asarray(got[key])
            assert got_np.dtype == np.asarray(value).dtype == np.float32
            np.testing.assert_array_equal(got_np, np.asarray(value))


@pytest.mark.parametrize("mapping_type", ["mlp", "transformer"])
def test_mapper_params_from_reference_ckpt_equal_jax(mapping_type):
    sd = reference_state_dict(mapping_type)
    got = tconvert.mapper_params_from_reference_ckpt(sd, mapping_type)
    assert_trees_bit_equal(
        got, jconvert.mapper_params_from_reference_ckpt(sd, mapping_type))
    if mapping_type == "transformer":
        assert got["blocks"]["q"]["w"].shape == (LAYERS, D_MODEL, D_MODEL)
        assert not got["blocks"]["kv"]["b"].any()     # the absent bias


def test_converted_mlp_runs_as_the_reference_module():
    """The reference's mapper is nn.Sequential(Linear, Tanh, Linear): the
    port's mlp mapper on the converted weights computes it."""
    sd = reference_state_dict("mlp", seed=1)
    module = torch.nn.Sequential(
        torch.nn.Linear(PREFIX_SIZE, D_MODEL * N_PREFIX // 2),
        torch.nn.Tanh(),
        torch.nn.Linear(D_MODEL * N_PREFIX // 2, D_MODEL * N_PREFIX))
    module.load_state_dict({k.removeprefix("model.clip_project.model."): v
                            for k, v in sd.items() if ".model." in k})
    params = {name: {k: torch.from_numpy(v) for k, v in layer.items()}
              for name, layer in tconvert.mapper_params_from_reference_ckpt(
                  sd, "mlp").items()}
    cfg = MapperConfig(mapping_type="mlp", prefix_size=PREFIX_SIZE,
                       d_model=D_MODEL, prefix_length=N_PREFIX,
                       clip_length=N_PREFIX)
    x = torch.randn(3, PREFIX_SIZE, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = module(x).reshape(3, N_PREFIX, D_MODEL)
    torch.testing.assert_close(mapper_apply(cfg, params, x).reshape(want.shape),
                               want, rtol=1e-5, atol=1e-5)


def test_reference_conversion_refusals():
    with pytest.raises(ValueError, match="clip_project"):
        tconvert.mapper_params_from_reference_ckpt(
            {"model.lm.encoder.weight": torch.zeros(2)}, "mlp")
    with pytest.raises(ValueError, match="unsupported mapping_type"):
        tconvert.mapper_params_from_reference_ckpt(
            reference_state_dict("mlp"), "perceiver")


@pytest.mark.parametrize("mapping_type", ["mlp", "transformer"])
def test_convert_reference_checkpoint_equals_jax(tmp_path, mapping_type):
    """Both tools on one Lightning checkpoint: the port's
    trainable_state.pt holds JAX's restored mapper bit for bit; a model_NN
    output is recorded in its parent's index."""
    ckpt = tmp_path / "model_04.ckpt"
    torch.save({"state_dict": reference_state_dict(mapping_type, 3),
                "epoch": 4}, ckpt)
    jref.convert(str(ckpt), mapping_type, str(tmp_path / "jax"))
    want = jckpt.load_checkpoint(str(tmp_path / "jax"))["mapper"]
    saved = tmp_path / "saved_model"
    out = tref.convert(str(ckpt), mapping_type, str(saved / "model_04"))
    assert tckpt.get_checkpoint_model_path(str(saved)) == out
    state = tckpt.load_checkpoint(out)
    assert list(state) == ["mapper"]
    assert_trees_bit_equal(jax.tree.map(lambda t: t.numpy(), state["mapper"]),
                           jax.tree.map(np.asarray, want))
    other = tref.convert(str(ckpt), mapping_type, str(tmp_path / "elsewhere"))
    assert not os.path.exists(tmp_path / "checkpoint_index.json")
    assert_trees_bit_equal(tckpt.load_checkpoint(other)["mapper"],
                           state["mapper"])


def jax_optimizer_run(cfg, params, grads):
    """(mapper, optax state) after the micro-steps ``grads``."""
    tx, _ = jopt.make_optimizer(cfg, TOTAL_STEPS)

    @jax.jit
    def step(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        p, state = step(jax.tree.map(jnp.asarray, g), state, p)
    return p, state, step


def adam_state(state):
    """The ScaleByAdamState inside an optax state."""
    if isinstance(state, optax.ScaleByAdamState):
        return state
    if isinstance(state, tuple):
        for child in state:
            found = adam_state(child)
            if found is not None:
                return found
    return None


# (micro-steps accumulated over, clipping, micro-steps before the save):
# plain AdamW after two updates; MultiSteps halfway through a second
# accumulation (a non-zero acc); MultiSteps before its first update
ORBAX_CASES = [(1, 0.0, 2), (2, 0.5, 3), (4, 0.0, 2)]


@pytest.mark.parametrize("accumulate,clipping,steps", ORBAX_CASES)
def test_orbax_checkpoint_converts_and_resumes(tmp_path, accumulate,
                                               clipping, steps):
    cfg = config("linear", 2, clipping, accumulate)
    params, grads = params_and_grads(4)
    p, state, step = jax_optimizer_run(cfg, params, grads[:steps])
    jax_saved = str(tmp_path / "jax_saved")
    jckpt.save_checkpoint(jax_saved, 1, {"mapper": p, "opt_state": state,
                                         "epoch": np.asarray(1)},
                          metric_value=0.5)
    port_saved = str(tmp_path / "port_saved")
    paths = torbax.convert(jax_saved, port_saved)
    assert paths == [os.path.join(port_saved, "model_01")]
    with open(os.path.join(jax_saved, "checkpoint_index.json")) as fh:
        index = json.load(fh)
    with open(os.path.join(port_saved, "checkpoint_index.json")) as fh:
        assert json.load(fh) == index
    converted = tckpt.load_checkpoint(
        tckpt.get_checkpoint_model_path(port_saved, load_best_model=True))
    assert converted["epoch"] == 1
    assert_trees_bit_equal(jax.tree.map(lambda t: t.numpy(),
                                        converted["mapper"]),
                           jax.tree.map(np.asarray, p))
    opt = converted["opt_state"]
    adam = adam_state(state if accumulate == 1 else state.inner_opt_state)
    for name, want in (("mu", adam.mu), ("nu", adam.nu)) + (
            (("acc", state.acc_grads),) if accumulate > 1 else ()):
        leaves = jax.tree.leaves(want)
        assert len(opt[name]) == len(leaves)
        for got, w in zip(opt[name], leaves):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert opt["applied"] == int(adam.count) == steps // accumulate
    assert opt["mini_step"] == (0 if accumulate == 1
                                else int(state.mini_step)) == steps % accumulate
    if accumulate == 1:
        assert opt["acc"] is None

    # both runs go on from the checkpoint with the same gradients
    for g in grads[steps:]:
        p, state = step(jax.tree.map(jnp.asarray, g), state, p)
    tree = port_tree(jax.tree.map(lambda t: t.numpy(), converted["mapper"]))
    optimizer = topt.make_optimizer(cfg, TOTAL_STEPS,
                                    topt.tree_leaves(tree))[0]
    optimizer.load_state_dict(opt)
    run_port(cfg, tree, grads[steps:], optimizer=optimizer)
    assert optimizer.applied == len(grads) // accumulate
    for got, w in zip(topt.tree_leaves(tree), jax.tree.leaves(p)):
        w = np.asarray(w)
        err = np.abs(got.detach().numpy() - w).max()
        assert err <= PARAM_REL * np.abs(w).max(), err


def test_orbax_reader_imports_no_jax(tmp_path):
    """One checkpoint directory (not the saved_model directory) converted
    in a process that imports neither jax nor orbax; the port's
    load_checkpoint still refuses the Orbax directory, naming the tool."""
    src = jckpt.save_checkpoint(
        str(tmp_path / "jax_saved"), 3,
        {"mapper": {"fc1": {"w": jnp.arange(6.0).reshape(2, 3)}},
         "epoch": np.asarray(3)})
    out = tmp_path / "port_saved"
    code = (
        "import sys\n"
        "from explicit_alignment_for_vqa_tasks_tpu_torch.tools import "
        "convert_orbax_checkpoint as c\n"
        f"print(c.convert({src!r}, {str(out)!r}))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'orbax'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert tckpt.get_checkpoint_model_path(str(out)) == str(out / "model_03")
    state = tckpt.load_checkpoint(str(out / "model_03"))
    assert state["epoch"] == 3 and "opt_state" not in state
    np.testing.assert_array_equal(state["mapper"]["fc1"]["w"].numpy(),
                                  np.arange(6.0, dtype=np.float32).reshape(2, 3))
    with pytest.raises(ValueError, match="convert_orbax_checkpoint"):
        tckpt.load_checkpoint(src)


def test_orbax_converter_names_tensorstore_when_missing(tmp_path,
                                                        monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    src = jckpt.save_checkpoint(str(tmp_path / "s"), 0, {
        "mapper": {"w": jnp.ones(2)}})
    with pytest.raises(ImportError, match="tensorstore"):
        torbax.convert(src, str(tmp_path / "out"))
    with pytest.raises(FileNotFoundError, match="saved_model"):
        torbax.convert(str(tmp_path), str(tmp_path / "out"))


@pytest.mark.parametrize("layout", [{"use_ocdbt": False},
                                    {"use_zarr3": True}])
def test_orbax_reader_takes_every_layout(tmp_path, layout):
    """Arrays as files of their own (no OCDBT), and zarr v3: the same tree
    as orbax's default layout (OCDBT, zarr v2) gives."""
    import orbax.checkpoint as ocp

    tree = {"mapper": {"fc1": {"w": jnp.arange(6.0).reshape(2, 3),
                               "b": jnp.ones(3)}},
            "epoch": np.asarray(2),
            "opt_state": (optax.EmptyState(),
                          {"count": jnp.asarray(3, jnp.int32)})}
    path = str(tmp_path / "ckpt")
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(**layout)).save(path, tree)
    got = torbax.read_orbax_tree(path)
    assert got["opt_state"]["0"] is None
    assert int(got["opt_state"]["1"]["count"]) == 3 and int(got["epoch"]) == 2
    np.testing.assert_array_equal(got["mapper"]["fc1"]["w"],
                                  np.arange(6.0, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(got["mapper"]["fc1"]["b"],
                                  np.ones(3, np.float32))
