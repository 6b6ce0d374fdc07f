"""``main`` over several local processes, with what each rank saw kept.

A user runs the eval over processes with a launcher
(``torchrun --nproc_per_node 2 -m explicit_alignment_for_vqa_tasks_tpu_torch.main
CONFIG --mode test ...``); this tool starts the same ``main.run`` in
``--nproc`` processes itself (the launcher's environment: ``MASTER_ADDR``
127.0.0.1, a free ``MASTER_PORT``, ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``), so that a check can see each rank's part:

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
calibrates), the files under its experiment folder, and the message of a
``NotImplementedError`` where the run refused (a training run over
processes). All ranks run on the card of their ``LOCAL_RANK`` (modulo the
card count) unless ``--device`` is given.
"""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

REPO_ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch(main_argv: List[str], nproc: int, out: Path,
           device: Optional[str] = None, timeout: float = 600.0
           ) -> List[Dict]:
    """``main.run(main_argv)`` in ``nproc`` processes; each rank's record,
    in rank order. Raises when a process fails or outlives ``timeout``
    seconds (every process is stopped first)."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    base = dict(os.environ, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()), WORLD_SIZE=str(nproc))
    cmd = [sys.executable, "-m", __spec__.name, "--worker", "--out",
           str(out), *(["--device", device] if device else []), "--",
           *main_argv]
    procs = [subprocess.Popen(cmd, cwd=REPO_ROOT, env=dict(
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
        raise RuntimeError(f"multiprocess_eval: exit codes {codes}")
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

    rank = int(os.environ["RANK"])
    folder = out / f"rank{rank}"
    argv = list(main_argv) + ([] if "--opts" in main_argv else ["--opts"])
    argv.append(f"EXPERIMENT_FOLDER={folder}")
    record: Dict = {"rank": rank, "error": None, "metrics": None,
                    "shard": None, "batches": None, "predictions": None,
                    "stats_local": None, "stats": None}
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
    try:
        executor, record["metrics"] = eval_main.run(argv, device=device)
    except NotImplementedError as exc:
        record["error"] = str(exc)
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
