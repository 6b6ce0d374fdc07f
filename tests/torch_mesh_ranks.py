"""Gloo CPU ranks for the port's mesh tests, and what each rank runs.

``run_ranks(target, world, folder, *args)`` starts ``world`` processes
(spawned, one thread each), builds their gloo group, calls
``target(rank, *args)`` in each and returns each rank's result, in rank
order. The targets live here, apart from the test files, so that a rank
imports torch and the port only (never JAX): the tests hold the ranks'
results against the JAX package in their own process.
"""

from __future__ import annotations

import os
import pickle
import socket
from pathlib import Path
from typing import Any, Callable, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = 120.0     # seconds a run of ranks may take


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _entry(target: Callable, rank: int, world: int, port: int, folder: str,
           args: tuple) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        result = target(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(folder, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


def run_ranks(target: Callable, world: int, folder: Path, *args: Any
              ) -> List[Any]:
    """``target(rank, *args)`` in ``world`` spawned gloo ranks; their
    results in rank order. Fails when a rank fails or outlives TIMEOUT."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(target, r, world, port, str(folder), args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"ranks exited with {codes}"
    return [pickle.loads((folder / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy() if torch.is_tensor(tree) \
        else tree


# ---------------------------------------------------------------------------
# The tensor-parallel T5 (tests/test_torch_tp_t5.py)
# ---------------------------------------------------------------------------

# (name, tpu.mesh sizes, the ranks of the mesh; None for all four)
TP_MESHES = (
    ("data1_model2", {"data": 1, "model": 2}, (0, 1)),
    ("data2_model2", {"data": 2, "model": 2}, None),
    ("dcn2_data1_model2", {"dcn_data": 2, "data": 1, "model": 2}, None),
)


def tp_case_config(case: dict):
    """The port's VCT0Config of a case (small_test widths)."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import (
        mappers as tmap,
        t5 as tt5,
        vct0 as tvct0,
    )

    lm = dict(case["lm"])
    if lm.pop("bf16", False):
        lm["dtype"] = torch.bfloat16
    return tvct0.VCT0Config(lm=tt5.T5Config.small_test(**lm),
                            mapper=tmap.MapperConfig(**case["mapper"]))


def tp_worker(rank: int, params_np: dict, cases: dict, inputs: dict) -> dict:
    """Each case under each mesh of TP_MESHES that holds this rank: the
    whole tree quantized where the case asks, split by shard_lm_params,
    the batch split by the data coordinate; its encoder states and its
    generate tokens (and the beam's where the case asks), keyed by (mesh,
    case), with the rank's data index and model rank; and its leaves of
    shard_lm_params on (data 2, model 2) of the tree quantized by
    quantize_encoder_ffn and quantize_decoder_step."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (
        vct0_params_from_numpy,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import (
        t5 as tt5,
        vct0 as tvct0,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.parallel import mesh as pm

    out = {}
    for mesh_name, sizes, ranks in TP_MESHES:
        mesh = pm.make_mesh({"tpu": {"mesh": sizes}}, ranks)
        if not mesh.member:
            continue
        batch = pm.shard_batch(mesh, inputs)
        with mesh:
            for name, case in cases.items():
                cfg = tp_case_config(case)
                dtype = cfg.lm.dtype
                params = vct0_params_from_numpy(params_np, dtype, "cpu")
                params["lm"] = tvct0.quantize_int8_encoder(params["lm"],
                                                           cfg.lm)
                params["lm"] = pm.shard_lm_params(mesh, params["lm"])
                model = tvct0.VCT0Model(cfg, params)
                with torch.inference_mode():
                    embeds, mask = model.encoder_calibration_batch(
                        batch["prefix"], batch["ids"], batch["mask"])
                    hidden = tt5.t5_encode(params["lm"], cfg.lm,
                                           inputs_embeds=embeds,
                                           attention_mask=mask)
                tokens, _ = model.generate(batch["prefix"], batch["ids"],
                                           batch["mask"],
                                           max_new_tokens=case["steps"])
                rec = {"data": mesh.data_index, "model": mesh.model_rank,
                       "hidden": hidden.float().numpy(),
                       "tokens": tokens.numpy()}
                if case.get("beams"):
                    rec["beam"] = model.generate(
                        batch["prefix"], batch["ids"], batch["mask"],
                        max_new_tokens=case["steps"],
                        num_beams=case["beams"])[0].numpy()
                out[(mesh_name, name)] = rec
    mesh = pm.make_mesh({"tpu": {"mesh": {"data": 2, "model": 2}}})
    lm = vct0_params_from_numpy(params_np, torch.float32, "cpu")["lm"]
    lm = tt5.quantize_decoder_step(tt5.quantize_encoder_ffn(lm))
    out.update(shards=numpy_tree(pm.shard_lm_params(mesh, lm)),
               shards_data=mesh.data_index, shards_model=mesh.model_rank)
    return out


# ---------------------------------------------------------------------------
# Data- and tensor-parallel training (tests/test_torch_dp_train.py)
# ---------------------------------------------------------------------------

def train_config():
    from explicit_alignment_for_vqa_tasks_tpu_torch.utils.attr_dict import (
        AttrDict,
    )

    return AttrDict(train=AttrDict(
        lr=1e-2, scheduler="none", adam_epsilon=1e-8,
        additional=AttrDict(warmup_steps=0, gradient_clipping=0.0,
                            gradient_accumulation_steps=1)))


def train_executor(params_np: dict, lm: dict, mapper: dict):
    """The port's VCT0Executor over the active mesh (or none), built from
    a JAX tree without a data loader: its model, ``_setup_mesh`` and its
    optimizer, as its constructor builds them."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (
        vct0_params_from_numpy,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import (
        mappers as tmap,
        t5 as tt5,
        vct0 as tvct0,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.optimization import (
        make_optimizer,
        tree_leaves,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.vct0_executor import (
        VCT0Executor,
    )

    cfg = tvct0.VCT0Config(lm=tt5.T5Config.small_test(**lm),
                           mapper=tmap.MapperConfig(**mapper))
    ex = VCT0Executor.__new__(VCT0Executor)
    ex.config, ex.global_step, ex.current_epoch = train_config(), 0, 0
    ex.multi_logger, ex.mesh = None, None
    ex.model = tvct0.VCT0Model(cfg, vct0_params_from_numpy(
        params_np, torch.float32, "cpu"))
    ex._setup_mesh(ex.model)
    leaves = tree_leaves(ex.model.params["mapper"])
    for t in leaves:
        t.requires_grad_(True)
    ex.optimizer, ex.schedule = make_optimizer(ex.config, 10, leaves)
    return ex


def _batch(rows: dict):
    from explicit_alignment_for_vqa_tasks_tpu_torch.utils.attr_dict import (
        AttrDict,
    )

    return AttrDict(clip_embeddings=rows["clip"], labels=rows["labels"])


def dp_worker(rank: int, params_np: dict, lm: dict, mapper: dict,
              union: dict, short: list, ckpt_dir: str) -> dict:
    """On (data 2, model 2): two training steps of VCT0Executor on this
    data rank's half of the union batch (the first step's loss and mapper
    gradients kept), the mapper and the optimizer's moments after them;
    then an epoch of ``short[data]`` batches through ``_train_batches``
    (the shards one batch apart), its step count and the mapper after it,
    written by rank 0 as a checkpoint. On (data 1, model 2), ranks 0 and 1:
    the checkpoint restored, its mapper and its loss on the union batch."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.parallel import mesh as pm
    from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (
        checkpointing as tckpt,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.utils.attr_dict import (
        AttrDict,
    )

    out = {}
    mesh = pm.make_mesh({"tpu": {"mesh": {"data": 2, "model": 2}}})
    with mesh:
        ex = train_executor(params_np, lm, mapper)
        grads = []
        step = ex.optimizer.step

        def recorded_step():
            grads.append([p.grad.detach().clone().numpy()
                          for p in ex.optimizer.params])
            return step()

        ex.optimizer.step = recorded_step
        batch = _batch(pm.shard_batch(mesh, union))
        losses = [float(ex.training_step(batch, i)["loss"]) for i in range(2)]
        out.update(data=mesh.data_index, model=mesh.model_rank,
                   losses=losses, grads=grads[0],
                   mapper=numpy_tree(ex.model.params["mapper"]),
                   moments=[t.numpy() for t in ex.optimizer.mu
                            + ex.optimizer.nu])
        ex.data_loader = AttrDict(train_dataloader=[
            _batch(rows) for rows in short[mesh.data_index]])
        steps = 0
        for i, b in enumerate(ex._train_batches()):
            ex.training_step(b, i)
            steps += 1
        out.update(short_steps=steps, short_local=len(short[mesh.data_index]),
                   short_mapper=numpy_tree(ex.model.params["mapper"]))
        tckpt.save_checkpoint(ckpt_dir, 0, ex.trainable_state())
    dist.barrier()
    mesh = pm.make_mesh({"tpu": {"mesh": {"data": 1, "model": 2}}}, (0, 1))
    if mesh.member:
        with mesh:
            ex = train_executor(params_np, lm, mapper)
            state = dict(tckpt.load_checkpoint(
                tckpt.get_checkpoint_model_path(ckpt_dir)))
            state.pop("epoch", None)
            ex.load_trainable_state(state)
            with torch.no_grad():
                loss = ex._loss(_batch(union))
            out.update(restored=numpy_tree(ex.model.params["mapper"]),
                       restored_loss=float(loss),
                       restored_mu=[t.numpy() for t in ex.optimizer.mu])
    return out


# ---------------------------------------------------------------------------
# The tools' data meshes (tests/test_torch_mesh_tools.py)
# ---------------------------------------------------------------------------

def tools_worker(rank: int, knn_cases: list, rices_argv: list,
                 clip_tree: dict, images: np.ndarray, text_ids: np.ndarray
                 ) -> dict:
    """Over ``make_data_mesh(-1)`` (every rank): each kNN case's result;
    the run_rices CLI with ``--mesh_data -1`` (rank 0 writes); the small
    CLIP image and text encoders' embeddings of ``images`` / ``text_ids``
    (batch 4, a slice of each batch a rank); the errors of a batch that
    does not divide and of a --mesh_data of 3 in a world of 4."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (
        clip_text_params_from_numpy,
        clip_vision_params_from_numpy,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.in_context_example_selection import (
        run_rices,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip
    from explicit_alignment_for_vqa_tasks_tpu_torch.ops import knn as tknn
    from explicit_alignment_for_vqa_tasks_tpu_torch.parallel import mesh as pm
    from explicit_alignment_for_vqa_tasks_tpu_torch.tools import clip_encoder

    mesh = pm.make_data_mesh(-1)
    out = {"mesh": dict(mesh.shape), "data": mesh.data_index, "knn": []}
    for queries, database, k in knn_cases:
        out["knn"].append(tknn.knn_search(queries, database, k, mesh=mesh,
                                          device="cpu", query_chunk=5))
    run_rices.main(rices_argv, device="cpu")
    encoder = clip_encoder.ClipImageEncoder(
        tclip.CLIPVisionConfig.small_test(),
        clip_vision_params_from_numpy(clip_tree["vision"], torch.float32,
                                      "cpu"),
        batch_size=4, mesh=-1, device="cpu")
    out["image"] = np.concatenate([encoder.encode_batch(images[:4]),
                                   encoder.encode_batch(images[4:])])
    text = clip_encoder.ClipTextEncoder(
        tclip.CLIPTextConfig.small_test(),
        clip_text_params_from_numpy(clip_tree["text"], torch.float32, "cpu"),
        batch_size=4, mesh=mesh, device="cpu")
    out["text"] = text.encode_ids(text_ids)
    out["errors"] = []
    for build in (lambda: clip_encoder.ClipImageEncoder(
                      tclip.CLIPVisionConfig.small_test(), {}, batch_size=6,
                      mesh=mesh, device="cpu"),
                  lambda: pm.make_data_mesh(3),
                  lambda: pm.make_data_mesh(8)):
        try:
            build()
        except ValueError as exc:
            out["errors"].append(str(exc))
    return out


# ---------------------------------------------------------------------------
# The mesh's groups and exchanges (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------

def mesh_worker(rank: int) -> dict:
    """On (data 2, model 2) and (dcn_data 2, data 1, model 2): this rank's
    coordinates, the ranks of its axis groups, its rows of a global batch,
    a broadcast mapper, the gathered predictions, the metric sum, the data
    axes' gradient sum and maximum, and the conjugate pair's forward and
    backward."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.parallel import gather
    from explicit_alignment_for_vqa_tasks_tpu_torch.parallel import mesh as pm

    out = {}
    for name, sizes in (("2d", {"data": 2, "model": 2}),
                        ("dcn", {"dcn_data": 2, "data": 1, "model": 2})):
        mesh = pm.make_mesh({"tpu": {"mesh": sizes}})
        with mesh:
            rec = {"coords": dict(mesh.coords), "data": mesh.data_index,
                   "shard": pm.data_shard()}
            rec["groups"] = {
                ax: sorted(dist.get_process_group_ranks(g))
                for ax, g in mesh.groups.items()}
            rec["data_group"] = sorted(dist.get_process_group_ranks(
                mesh.data_group))
            batch = {"x": np.arange(8)[:, None] * np.ones((1, 3)),
                     "ids": [1, 2]}
            rec["rows"] = pm.shard_batch(mesh, batch)["x"][:, 0].tolist()
            mapper = {"w": torch.full((2, 2), float(rank))}
            pm.replicate_params(mesh, mapper)
            rec["mapper"] = mapper["w"].tolist()
            rec["predictions"] = gather.gather_predictions_to_host0(
                [f"d{mesh.data_index}m{mesh.model_rank}"])
            rec["psum"] = gather.metric_psum(torch.tensor(1.0 + rank)).item()
            w = torch.zeros(3, requires_grad=True)
            w.grad = torch.full((3,), float(rank))
            pm.sum_grads_over_data(mesh, [w])
            rec["grad"] = w.grad.tolist()
            rec["max"] = pm.data_max(rank, mesh)
            x = torch.full((2,), float(rank + 1), requires_grad=True)
            y = pm.reduce_from_model(pm.copy_to_model(x, mesh) * 2.0, mesh)
            y.sum().backward()
            rec["reduced"], rec["x_grad"] = y.tolist(), x.grad.tolist()
            out[name] = rec
    return out
