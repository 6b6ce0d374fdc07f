"""The port and chip_smoke.py import neither jax nor the JAX package (nor,
at import time, PIL, transformers, orbax, tensorstore, datasets, pyarrow or
matplotlib), and the port's device rule holds."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "explicit_alignment_for_vqa_tasks_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "explicit_alignment_for_vqa_tasks_tpu")
# absent on the card's machine (or, tensorstore, not known there): imported
# inside the functions that use them
NOT_AT_IMPORT = ("PIL", "transformers", "orbax", "tensorstore", "datasets",
                 "pyarrow", "matplotlib")


def port_modules():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def python_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_every_kernel_module_is_scanned():
    """The scans below cover every module of the port, the kernel
    wrappers' modules among them."""
    names = port_modules()
    for module in ("ops.decode_attention", "ops.fused_attention_block",
                   "models.t5", "kernels", "models.clip", "models.hf_convert",
                   "tools.clip_encoder", "models.gpt2", "models.clipcap",
                   "ops.attention", "ops.decoding",
                   "tools.extract_contrastive_image_embeddings",
                   "tools.kernel_probe", "tools.bench_generate", "main",
                   "registry", "trainers", "trainers.model_factory",
                   "utils", "utils.config_system", "utils.jsonnet_eval",
                   "utils.attr_dict", "utils.seed", "utils.loggers",
                   "utils.vqa_eval", "utils.vqa_tools", "tools.time_vqa_scoring", "data",
                   "data.tokenization", "data.loader",
                   "data.in_context_examples", "data.module_parser",
                   "data.vqa2_datasets", "data.data_loader_wrapper",
                   "data.data_loader_vqa2", "trainers.checkpointing",
                   "trainers.metrics_processors", "trainers.base_executor",
                   "trainers.few_shot_vqa_executor", "ops.knn",
                   "in_context_example_selection",
                   "in_context_example_selection.rices",
                   "in_context_example_selection.run_rices",
                   "in_context_example_selection.make_random_examples",
                   "tools.extract_contrastive_text_embeddings",
                   "tools.extract_clip_embeddings_conceptual_captions",
                   "tools.rices_at_scale",
                   "tools.convert_reference_checkpoint",
                   "tools.convert_orbax_checkpoint", "utils.device_stats",
                   "tools.generate_captions", "tools.int8_drift_study",
                   "tools.bf16_drift_study", "tools.decode_profile",
                   "tools.replicate_baseline", "tools.replicate_dryrun",
                   "tools.answer_length_analysis", "tools.report_plots",
                   "tools.visualise_in_context_examples",
                   "tools.e2e_fixtures", "tools.train_step_study",
                   "tools.vit_studies", "tools.vit_b_study",
                   "tools.vit_l_study", "tools.eval_pipeline_bench",
                   "tools.hw_smoke", "tools.multiprocess_eval", "parallel",
                   "parallel.gather", "parallel.multihost",
                   "parallel.mesh", "trainers.vct0_executor",
                   "trainers.clipcap_executor",
                   "data.data_loader_conceptual_captions", "device"):
        assert f"{PORT.name}.{module}" in names, module


def test_import_in_subprocess_pulls_in_no_jax():
    modules = port_modules() + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        f"late = sorted(m for m in sys.modules if m.split('.')[0] in {NOT_AT_IMPORT!r})\n"
        "assert not late, late\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", python_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")


def test_resolve_device_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"


def test_tensorstore_is_imported_only_by_the_orbax_converter():
    importers = []
    for path in python_files():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            if any(name.split(".")[0] == "tensorstore" for name in names):
                importers.append(path.relative_to(REPO).as_posix())
    assert importers == [f"{PORT.name}/tools/convert_orbax_checkpoint.py"]
