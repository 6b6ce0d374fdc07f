"""``main`` over several local processes, with what each rank saw kept.

A user runs the eval or the training over processes with a launcher
(``torchrun --nproc_per_node 2 -m explicit_alignment_for_vqa_tasks_tpu_torch.main
CONFIG --mode test ...``, the mesh's sizes in ``--opts tpu.mesh.data=...
tpu.mesh.model=...``); this tool starts the same ``main.run`` in
``--nproc`` processes itself (the launcher's environment: ``MASTER_ADDR``
127.0.0.1, a free ``MASTER_PORT``, ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``), so that a check can see each rank's
part:

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.multiprocess_eval \\
        --nproc 2 --out DIR [--device cpu] -- CONFIG --mode test ... --opts ...

Each rank runs with its own ``EXPERIMENT_FOLDER`` (``DIR/rank{r}``, so that
what each wrote can be told apart; a test run names its checkpoint with
``test.load_model_path``) and writes ``DIR/rank{r}.pkl``, read from the
run's own outputs: its metrics, the question ids of its test loader's shard
in the order it yields them, its loader's batch count, the predictions in
the ``answers.pkl`` it wrote (rank 0's: the gathered list), the launches of
every kernel wrapper in the run (the counts set to 0 before it), the int8
calibration statistics before and after the max-reduce (where the run
calibrates), the files under its experiment folder, the message of a
``NotImplementedError`` where the run refused (the pipelined mesh), the
collective backend and the mesh, the run's first encoder output and first
decode step's logits (``FirstOutputs``), and of a training run (``TrainTrace``)
each step's loss, the SHA-256 of the first step's mapper gradient and of
the mapper and the optimizer's moments after the run (rank 0 also writes
that gradient to ``DIR/first_grad.pt``). All ranks run on the card of their
``LOCAL_RANK`` (modulo the card count) unless ``--device`` is given.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

REPO_ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_command(cmd: List[str], nproc: int, timeout: float = 600.0,
                   cwd: Path = REPO_ROOT) -> None:
    """``cmd`` in ``nproc`` local processes with a launcher's environment,
    as ``torchrun --nproc_per_node nproc`` starts them. Raises when a
    process fails or outlives ``timeout`` seconds (every process is
    stopped first)."""
    base = dict(os.environ, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()), WORLD_SIZE=str(nproc),
                LOCAL_WORLD_SIZE=str(nproc))
    procs = [subprocess.Popen(cmd, cwd=cwd, env=dict(
        base, RANK=str(r), LOCAL_RANK=str(r))) for r in range(nproc)]
    deadline = time.monotonic() + timeout
    try:
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f"{cmd[1:3]}: exit codes {codes}")


def launch(main_argv: List[str], nproc: int, out: Path,
           device: Optional[str] = None, timeout: float = 600.0
           ) -> List[Dict]:
    """``main.run(main_argv)`` in ``nproc`` processes; each rank's record,
    in rank order. Raises when a process fails or outlives ``timeout``
    seconds (every process is stopped first)."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    launch_command([sys.executable, "-m", __spec__.name, "--worker", "--out",
                    str(out), *(["--device", device] if device else []),
                    "--", *main_argv], nproc, timeout)
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(nproc)]


def _numpy(stats: Dict) -> Dict:
    return {k: v.detach().float().cpu().numpy() for k, v in stats.items()}


def kernel_wrappers() -> Dict:
    """The port's kernel wrappers by name: each adds one to its
    ``launches`` where it launches its kernel."""
    from ..ops import attention, decode_attention, fused_attention_block
    return {fn.__name__: fn
            for mod in (attention, decode_attention, fused_attention_block)
            for fn in vars(mod).values()
            if callable(fn) and hasattr(fn, "launches")}


def sha256(tensors) -> str:
    """The SHA-256 of tensors' bytes, in order (bit-identity across
    processes)."""
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().float().cpu().contiguous().numpy()
                      .tobytes())
    return digest.hexdigest()


class TrainTrace:
    """For one ``main.run`` of a training executor: each training step's
    loss, and the first optimizer step's mapper gradient (flat fp32, after
    the data axes' sum). Installed for the run and taken off after."""

    def __enter__(self) -> "TrainTrace":
        from ..trainers import base_executor, optimization

        self.losses: List[float] = []
        self.first_grad = None
        self._owners = (base_executor.BaseExecutor,
                        optimization.MultiStepAdamW)
        self._train, self._step = (self._owners[0].train,
                                   self._owners[1].step)
        trace, train, step = self, self._train, self._step

        def traced_train(executor):
            inner = executor.training_step

            def training_step(batch, batch_idx):
                out = inner(batch, batch_idx)
                trace.losses.append(float(out["loss"]))
                return out

            executor.training_step = training_step
            try:
                return train(executor)
            finally:
                del executor.training_step

        def traced_step(optimizer):
            if trace.first_grad is None:
                trace.first_grad = torch.cat([
                    p.grad.detach().reshape(-1).float().cpu()
                    for p in optimizer.params])
            return step(optimizer)

        self._owners[0].train = traced_train
        self._owners[1].step = traced_step
        return self

    def __exit__(self, *exc) -> None:
        self._owners[0].train = self._train
        self._owners[1].step = self._step


class FirstOutputs:
    """For one ``main.run``: the first call's output of ``t5.t5_encode``
    (the encoder's hidden states) and of ``t5.t5_decode_step`` (its fp32
    logits), as fp32 numpy arrays, so that a run on a mesh can be held
    against one process's where its tokens need not be equal (bf16).
    Installed for the run and taken off after."""

    NAMES = ("t5_encode", "t5_decode_step")

    def __enter__(self) -> "FirstOutputs":
        from ..models import t5 as t5_lib

        self.outputs: Dict = {}
        self._module = t5_lib
        self._fns = {name: getattr(t5_lib, name) for name in self.NAMES}
        for name, fn in self._fns.items():
            setattr(t5_lib, name, self._traced(name, fn))
        return self

    def _traced(self, name: str, fn):
        def traced(*args, **kwargs):
            out = fn(*args, **kwargs)
            if name not in self.outputs:
                first = out[0] if isinstance(out, tuple) else out
                self.outputs[name] = first.detach().float().cpu().numpy()
            return out
        return traced

    def __exit__(self, *exc) -> None:
        for name, fn in self._fns.items():
            setattr(self._module, name, fn)


def shard_question_ids(loader) -> List[int]:
    """The question ids ``loader`` yields, padding rows left out."""
    return [q for batch in loader
            for q, ok in zip(batch.question_ids, batch.sample_valid) if ok]


def worker(out: Path, device: Optional[str], main_argv: List[str]) -> None:
    """One rank: ``main.run`` with its own experiment folder, its record
    written to ``out/rank{RANK}.pkl``."""
    import torch.distributed as dist

    from .. import main as eval_main
    from ..models import vct0
    from ..parallel import mesh as pmesh
    from ..parallel.multihost import backend
    from ..trainers.optimization import tree_leaves

    rank = int(os.environ["RANK"])
    folder = out / f"rank{rank}"
    argv = list(main_argv) + ([] if "--opts" in main_argv else ["--opts"])
    argv.append(f"EXPERIMENT_FOLDER={folder}")
    record: Dict = {"rank": rank, "error": None, "metrics": None,
                    "shard": None, "batches": None, "predictions": None,
                    "stats_local": None, "stats": None, "backend": None,
                    "mesh": None, "coords": None}
    # the calibration's statistics are not among the run's outputs: the
    # model's reduce is wrapped to keep them
    reduce_max = vct0.max_across_processes
    stats_local, stats = {}, {}

    def max_recorded(value):
        key = f"stat{len(stats_local)}"
        stats_local[key] = value
        stats[key] = reduce_max(value)
        return stats[key]

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    vct0.max_across_processes = max_recorded
    trace, first = TrainTrace(), FirstOutputs()
    try:
        with trace, first:
            executor, record["metrics"] = eval_main.run(argv, device=device)
    except NotImplementedError as exc:
        record["error"] = str(exc)
    else:
        mesh = pmesh.active_mesh()
        record.update(backend=backend(), mesh=mesh and dict(mesh.shape),
                      coords=mesh and dict(mesh.coords))
        if trace.first_grad is not None:
            optimizer = executor.optimizer
            record.update(
                train_losses=trace.losses, steps=executor.global_step,
                first_grad_sha256=sha256([trace.first_grad]),
                mapper_sha256=sha256(tree_leaves(
                    executor.model.params["mapper"])),
                moments_sha256=sha256(optimizer.mu + optimizer.nu))
            if rank == 0:
                torch.save(trace.first_grad, out / "first_grad.pt")
            record["batches"] = len(executor.train_dataloader)
        else:
            record["shard"] = shard_question_ids(executor.test_dataloader)
            record["batches"] = len(executor.test_dataloader)
            answers = Path(executor.config.results_path) / "answers.pkl"
            if answers.is_file():
                record["predictions"] = pickle.loads(answers.read_bytes())
    finally:
        vct0.max_across_processes = reduce_max
        if dist.is_initialized():
            dist.destroy_process_group()
    record["launches"] = {name: fn.launches for name, fn in wrappers.items()}
    record["first_outputs"] = first.outputs
    if stats:
        record["stats_local"], record["stats"] = (_numpy(stats_local),
                                                  _numpy(stats))
    record["files"] = sorted(str(p.relative_to(folder))
                             for p in folder.rglob("*") if p.is_file())
    (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(record))


def main(argv: Optional[List[str]] = None) -> Optional[List[Dict]]:
    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index("--") if "--" in argv else len(argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--device", default=None,
                        help="every rank's device (the card by default)")
    parser.add_argument("--worker", action="store_true",
                        help="run as one rank (the launcher's environment "
                        "set)")
    args = parser.parse_args(argv[:split])
    main_argv = argv[split + 1:]
    if args.worker:
        worker(args.out, args.device, main_argv)
        return None
    records = launch(main_argv, args.nproc, args.out, args.device)
    for rec in records:
        print(f"rank {rec['rank']}: {len(rec['shard'] or [])} questions, "
              f"metrics {rec.get('metrics')}, error {rec['error']}",
              flush=True)
    return records


if __name__ == "__main__":
    main()
