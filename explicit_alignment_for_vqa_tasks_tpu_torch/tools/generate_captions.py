"""Caption images with a trained mapping network.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/generate_captions.py
(the reference's ``generate_captions.ipynb``): load a mapper checkpoint of
the port (``trainers.checkpointing.save_checkpoint``, or one converted by
``tools/convert_reference_checkpoint.py``), project CLIP embeddings, and
generate captions with the "Summarize: <extra_id_0>" prompt and an optional
forced decoder prefix ("A picture of") through the forced decode. The model
runs on the card unless ``--device cpu`` is given.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.generate_captions \\
        configs/vqa2/few_shot_vqa_hotpotqa.jsonnet \\
        --checkpoint .../saved_model/model_04 \\
        --embeddings coco_ViT-L_14@336px_val2014.pkl --out captions.txt

``--embeddings`` is a pickle ``{key: (1, d)}`` or, where pyarrow imports, a
parquet file with a ``clip_embeddings`` column; ``--opts`` takes dotted
config overrides (``model_config.TokenizerClass=SimpleTokenizer`` where
there is no ``transformers``).
"""

from __future__ import annotations

import argparse
import logging
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike

logger = logging.getLogger(__name__)


def generate_captions(
    model,
    tokenizer,
    clip_embeddings: np.ndarray,          # (N, prefix_size)
    prompt: str = "Summarize: <extra_id_0>",
    forced_prefix: Optional[str] = "A picture of",
    max_new_tokens: int = 20,
    batch_size: int = 32,
) -> List[str]:
    """Returns one caption per embedding row; ``model`` is a VCT0Model,
    which moves the arrays to its device."""
    captions: List[str] = []
    prompt_enc = tokenizer([prompt], return_tensors="np")
    decoder_input_ids = None
    if forced_prefix:
        forced = tokenizer(
            [forced_prefix], return_tensors="np"
        )["input_ids"][:, :-1]  # drop EOS; decode continues the prefix
        decoder_input_ids = np.concatenate(
            [np.zeros((1, 1), dtype=forced.dtype), forced], axis=1
        )

    for start in range(0, len(clip_embeddings), batch_size):
        chunk = np.asarray(clip_embeddings[start:start + batch_size],
                           dtype=np.float32)
        n = len(chunk)
        kwargs = dict(
            prefix=chunk[:, None, :],
            question_tokens=np.repeat(prompt_enc["input_ids"], n, axis=0),
            question_mask=np.repeat(prompt_enc["attention_mask"], n, axis=0),
            max_new_tokens=max_new_tokens,
        )
        if decoder_input_ids is not None:
            kwargs["decoder_input_ids"] = np.repeat(decoder_input_ids, n,
                                                    axis=0)
        tokens, _ = model.generate(**kwargs)
        for row in tokens.cpu().numpy():
            text = tokenizer.decode(row.tolist(), skip_special_tokens=True)
            if forced_prefix:
                text = f"{forced_prefix} {text}".strip()
            captions.append(text)
    return captions


def read_embeddings(path: str, limit: int) -> np.ndarray:
    """The first ``limit`` rows of a pickle ``{key: (1, d)}`` or of a
    parquet file's ``clip_embeddings`` column, as (N, d) fp32."""
    if path.endswith(".parquet"):
        import pyarrow.parquet as pq

        table = pq.read_table(path)
        rows = table.column("clip_embeddings").to_pylist()
    else:
        with open(path, "rb") as fh:
            rows = list(pickle.load(fh).values())
    return np.stack([np.asarray(e, dtype=np.float32).reshape(-1)
                     for e in rows[:limit]])


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("config", help="jsonnet config (model definition)")
    parser.add_argument("--checkpoint", required=True,
                        help="the port's model_NN directory or its "
                             "trainable_state.pt")
    parser.add_argument("--embeddings", required=True,
                        help="pickle {key: (1, d)} or parquet with "
                             "clip_embeddings")
    parser.add_argument("--out", required=True)
    parser.add_argument("--limit", type=int, default=32)
    parser.add_argument("--no_forced_prefix", action="store_true")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card")
    parser.add_argument("--opts", nargs="*", default=[],
                        help="dotted-path config overrides: a.b.c=value")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None,
         device: DeviceLike = None) -> Dict[str, Any]:
    """Writes the captions to ``--out``; returns {"captions": [...],
    "generate_s": the seconds of generate_captions alone}."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..data.tokenization import load_tokenizer
    from ..trainers.base_executor import tree_to_device
    from ..trainers.checkpointing import load_checkpoint
    from ..trainers.model_factory import build_model_from_config
    from ..utils.config_system import get_config_from_file, parse_optional_args

    config = parse_optional_args(get_config_from_file(args.config), args.opts)
    config.mode = "test"
    model, _ = build_model_from_config(config, device=device or args.device)
    state = dict(load_checkpoint(args.checkpoint))
    model.params["mapper"] = tree_to_device(state["mapper"], model.device)
    tokenizer = load_tokenizer(
        config.model_config.TokenizerClass,
        config.model_config.TokenizerModelVersion,
        config.model_config.get("SPECIAL_TOKENS", {}),
    )
    embeddings = read_embeddings(args.embeddings, args.limit)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)  # the checkpoint's copy
    start = time.perf_counter()
    captions = generate_captions(
        model, tokenizer, embeddings,
        forced_prefix=None if args.no_forced_prefix else "A picture of",
    )
    seconds = time.perf_counter() - start  # the tokens come back to the host
    with open(args.out, "w", encoding="utf-8") as fh:
        fh.write("\n".join(captions))
    logger.info("wrote %d captions to %s (%.3f s, %.2f captions/s)",
                len(captions), args.out, seconds, len(captions) / seconds)
    return {"captions": captions, "generate_s": seconds}


if __name__ == "__main__":
    main()
