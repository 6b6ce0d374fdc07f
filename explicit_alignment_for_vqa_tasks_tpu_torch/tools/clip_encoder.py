"""Batched CLIP encoding on the card: the engine of the extraction tools.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/clip_encoder.py.
Images are preprocessed on the host (PIL resize, centre crop, normalize),
batched to a fixed size (the last batch padded with zeros) and encoded by
one ``clip_encode_image`` call per batch. Over a data mesh of processes
(``mesh``: the tools' ``--mesh_data N`` or a ``parallel.mesh.Mesh``; JAX
``clip_encoder.py:51-80``) each rank encodes its contiguous slice of every
batch (the batch size must divide by N) and the slices are gathered to
every rank through the host, so that each rank returns what one card
returns. The JAX package's scoped-VMEM guard has no port.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..parallel.mesh import Mesh, MeshLike, resolve_mesh
from ..models.clip import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIPTextConfig,
    CLIPVisionConfig,
    clip_encode_image,
    clip_encode_text,
    init_clip_text_params,
    init_clip_vision_params,
    quantize_vision_blocks,
)

logger = logging.getLogger(__name__)

DEFAULT_MODEL = "openai/clip-vit-large-patch14-336"


def preprocess_image(image: np.ndarray, image_size: int) -> np.ndarray:
    """Resize shorter side to image_size, center crop, normalize —
    OpenAI CLIP preprocessing. Input HWC uint8/float, output HWC float32."""
    from PIL import Image

    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    if image.shape[-1] == 4:
        image = image[..., :3]
    pil = Image.fromarray(np.asarray(image, dtype=np.uint8))
    w, h = pil.size
    scale = image_size / min(w, h)
    pil = pil.resize(
        (max(image_size, int(round(w * scale))),
         max(image_size, int(round(h * scale)))),
        Image.BICUBIC,
    )
    w, h = pil.size
    left = (w - image_size) // 2
    top = (h - image_size) // 2
    pil = pil.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(pil, dtype=np.float32) / 255.0
    mean = np.asarray(CLIP_IMAGE_MEAN, dtype=np.float32)
    std = np.asarray(CLIP_IMAGE_STD, dtype=np.float32)
    return (arr - mean) / std


def _check_mesh(mesh: MeshLike, batch_size: int = 1) -> Optional[Mesh]:
    """The extraction mesh (None for one card); the fixed batch must
    divide over its data ways (JAX ``_check_encoder_mesh``)."""
    mesh = resolve_mesh(mesh)
    if mesh is not None and batch_size % mesh.data_size:
        raise ValueError(
            f"encoder batch_size {batch_size} must divide the mesh's "
            f"data={mesh.data_size} axis for sharded extraction")
    return mesh


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] >= rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])


def _encode_on_mesh(encode, x: torch.Tensor, mesh: Optional[Mesh]
                    ) -> torch.Tensor:
    """``encode(x)`` of a full fixed-size batch: on one card, or as each
    rank's contiguous slice gathered in rank order."""
    if mesh is None:
        return encode(x)
    from ..parallel.gather import all_gather_host

    rows = x.shape[0] // mesh.data_size
    mine = encode(x[mesh.data_index * rows:(mesh.data_index + 1) * rows])
    return torch.cat(all_gather_host(mine, mesh.group))


class ClipImageEncoder:
    """Batched image encoder with a fixed batch size, on ``device`` (the
    card unless the caller passes ``device="cpu"``). ``int8`` quantizes the
    blocks' projections once (``quantize_vision_blocks``, into a copy of
    the caller's params dict) and runs the int8 blocks. ``param_dtype``
    (bf16 by default) is the dtype of weights it loads or draws; the
    activations' is ``cfg.dtype``. Under ``cfg.fused_block`` at ViT-L/14@336
    both may be fp32 (models/clip.py: the split3 kernels' fp32 forms)."""

    def __init__(
        self,
        cfg: Optional[CLIPVisionConfig] = None,
        params: Optional[Dict] = None,
        model_version: str = DEFAULT_MODEL,
        batch_size: int = 256,
        param_dtype: Optional[torch.dtype] = None,
        use_pallas: bool = False,
        int8: bool = False,
        mesh: MeshLike = None,
        device: DeviceLike = None,
    ):
        self.mesh = _check_mesh(mesh, batch_size)
        self.cfg = cfg or CLIPVisionConfig.vit_l_14_336()
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.use_pallas = use_pallas
        param_dtype = param_dtype or torch.bfloat16
        if params is None:
            params = self._try_load_hf(model_version, param_dtype)
        if params is None:
            logger.warning(
                "no local CLIP weights for %r; random init from seed 0 "
                "(embeddings will not be meaningful; fine for perf and "
                "pipeline tests)", model_version)
            params = init_clip_vision_params(
                make_generator(0, self.device), self.cfg, param_dtype)
        self.params = params
        if int8:
            self.params = dict(params)   # the caller's dict stays as it is
            self.params["blocks_q8"] = quantize_vision_blocks(self.params)
            self.cfg = dataclasses.replace(self.cfg, int8=True)

    def _try_load_hf(self, model_version: str,
                     param_dtype: torch.dtype) -> Optional[Dict]:
        try:
            import transformers

            from ..convert import clip_vision_params_from_numpy
            from ..models.hf_convert import clip_vision_params_from_hf

            model = transformers.CLIPVisionModelWithProjection.from_pretrained(
                model_version, local_files_only=True)
            tree = clip_vision_params_from_hf(model.state_dict(), self.cfg)
            del model
            return clip_vision_params_from_numpy(tree, param_dtype,
                                                 self.device)
        except Exception as exc:
            logger.info("local CLIP weights unavailable: %s", exc)
            return None

    def encode_batch(self, images) -> np.ndarray:
        """(B <= batch_size, H, W, 3) preprocessed images (numpy or a
        tensor) -> (B, proj_dim) float32 numpy."""
        n = images.shape[0]
        x = torch.as_tensor(images).to(self.device)
        with torch.inference_mode():
            out = _encode_on_mesh(
                lambda rows: clip_encode_image(self.params, self.cfg, rows,
                                               use_pallas=self.use_pallas),
                _pad_rows(x, self.batch_size), self.mesh)
        return out[:n].float().cpu().numpy()

    def encode_iter(
        self, items: Iterable[Tuple[Any, np.ndarray]]
    ) -> Iterable[Tuple[Any, np.ndarray]]:
        """Stream (key, preprocessed image) pairs; yields (key, embedding)."""
        keys: List[Any] = []
        batch: List[np.ndarray] = []
        for key, image in items:
            keys.append(key)
            batch.append(image)
            if len(batch) == self.batch_size:
                embeddings = self.encode_batch(np.stack(batch))
                yield from zip(keys, embeddings)
                keys, batch = [], []
        if batch:
            embeddings = self.encode_batch(np.stack(batch))
            yield from zip(keys, embeddings)


class ClipTextEncoder:
    """Batched text encoder (question embeddings, RICES), on ``device``."""

    def __init__(
        self,
        cfg: Optional[CLIPTextConfig] = None,
        params: Optional[Dict] = None,
        model_version: str = DEFAULT_MODEL,
        batch_size: int = 512,
        param_dtype: Optional[torch.dtype] = None,
        mesh: MeshLike = None,
        device: DeviceLike = None,
    ):
        self.mesh = _check_mesh(mesh, batch_size)
        self.cfg = cfg or CLIPTextConfig()
        self.device = resolve_device(device)
        self.batch_size = batch_size
        param_dtype = param_dtype or torch.bfloat16
        self.tokenizer = self._try_load_tokenizer(model_version)
        if params is None:
            params = self._try_load_hf(model_version, param_dtype)
        if params is None:
            logger.warning("no local CLIP text weights; random init from "
                           "seed 0")
            params = init_clip_text_params(
                make_generator(0, self.device), self.cfg, param_dtype)
        self.params = params

    def _try_load_tokenizer(self, model_version: str):
        try:
            import transformers

            return transformers.CLIPTokenizerFast.from_pretrained(
                model_version, local_files_only=True)
        except Exception as exc:
            logger.info("local CLIP tokenizer unavailable: %s", exc)
            return None

    def _try_load_hf(self, model_version: str,
                     param_dtype: torch.dtype) -> Optional[Dict]:
        try:
            import transformers

            from ..convert import clip_text_params_from_numpy
            from ..models.hf_convert import clip_text_params_from_hf

            model = transformers.CLIPTextModelWithProjection.from_pretrained(
                model_version, local_files_only=True)
            tree = clip_text_params_from_hf(model.state_dict(), self.cfg)
            del model
            return clip_text_params_from_numpy(tree, param_dtype, self.device)
        except Exception as exc:
            logger.info("local CLIP text weights unavailable: %s", exc)
            return None

    def tokenize(self, texts: List[str]) -> np.ndarray:
        if self.tokenizer is None:
            raise RuntimeError(
                "CLIP tokenizer not available locally; pass token ids "
                "directly to encode_ids")
        enc = self.tokenizer(
            texts, padding="max_length",
            max_length=self.cfg.context_length, truncation=True,
            return_tensors="np",
        )
        return np.asarray(enc["input_ids"], dtype=np.int32)

    def encode_ids(self, input_ids) -> np.ndarray:
        """(B <= batch_size, L) token ids (numpy or a tensor) -> (B,
        proj_dim) float32 numpy; the batch is padded with id 0."""
        n = input_ids.shape[0]
        ids = torch.as_tensor(input_ids).to(self.device)
        with torch.inference_mode():
            out = _encode_on_mesh(
                lambda rows: clip_encode_text(self.params, self.cfg, rows),
                _pad_rows(ids, self.batch_size), self.mesh)
        return out[:n].float().cpu().numpy()

    def encode_texts(self, texts: List[str]) -> np.ndarray:
        out = []
        for start in range(0, len(texts), self.batch_size):
            ids = self.tokenize(texts[start:start + self.batch_size])
            out.append(self.encode_ids(ids))
        return np.concatenate(out) if out else np.zeros((0,))
