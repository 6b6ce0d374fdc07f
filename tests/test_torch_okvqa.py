"""The port's VinVL, Google-OCR, Oscar-caption and OK-VQA dataset modules
and OK-VQA scoring against the JAX package's, on the CPU: the loaders on
synthetic TSV / JSON files (features, the OCR text merged into the VinVL
boxes with its scores, the caption features, the cache files), and
``LoadOKVQAData`` with ``compute_okvqa_scores`` through the executor on
the tiny fp32 VC-T0 of tests/test_e2e.py, JAX's weights carried across."""

import copy
import json
import os
import pickle

import pytest

jax = pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu.data.data_loader_vqa2 import (  # noqa: E402
    DataLoaderVQA2 as JaxLoader,
)
from explicit_alignment_for_vqa_tasks_tpu.utils.attr_dict import (  # noqa: E402
    AttrDict as JAttrDict,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.data.data_loader_vqa2 import (  # noqa: E402
    DataLoaderVQA2 as PortLoader,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.attr_dict import (  # noqa: E402
    AttrDict as TAttrDict,
)
from test_torch_eval_e2e import (  # noqa: E402
    answers,
    assert_same_eval,
    configs,
    run_both,
)
from test_vqa2_loaders import base_config  # noqa: E402

FEATURE_MODULES = ("LoadVinVLFeatures", "LoadGoogleOCRFeatures",
                   "LoadOscarCaptionFeatures")


def write_features(folder, image_keys):
    """A VinVL TSV, per-image OCR JSON and an Oscar caption JSON for
    ``image_keys``: boxes that hold a polygon, that hold none, that nest
    (a polygon inside two boxes), a zero-area box; polygons with
    newlines in their text, outside every box, and one image with no OCR
    file."""
    folder.mkdir(parents=True, exist_ok=True)
    ocr_dir = folder / "ocr"
    ocr_dir.mkdir(exist_ok=True)
    captions = {}
    with open(folder / "vinvl.tsv", "w") as fh:
        for i, key in enumerate(image_keys):
            s = 10 + 7 * i
            prediction = {"objects": [
                {"rect": [0, 0, 100 + s, 80 + s], "class": "sign",
                 "conf": 0.9, "attributes": ["red", "large"],
                 "attribute_scores": [0.8, 0.2]},
                {"rect": [5, 5, 60, 40], "class": "plate", "conf": 0.7,
                 "attributes": ["white"], "attribute_scores": [0.6]},
                {"rect": [200, 200, 250 + s, 260], "class": "car",
                 "conf": 0.8, "attributes": [], "attribute_scores": []},
                {"rect": [30, 30, 30, 90], "class": "pole", "conf": 0.5,
                 "attributes": [], "attribute_scores": []},
            ]}
            fh.write(f"{key}\t{json.dumps(prediction)}\n")
            captions[key] = f"a {['red', 'blue', 'small'][i % 3]} sign {i}"
            if i % 4 == 3:
                continue  # no OCR for this image
            (ocr_dir / f"{key}_ocr.json").write_text(json.dumps({
                "filtered_text_annotations": [
                    {"description": f"STOP\nNOW {i}", "vertices":
                     [[10, 10], [50 + i, 10], [50 + i, 30], [10, 30 + i]]},
                    {"description": "MAIN ST", "vertices":
                     [[70, 50], [95, 52], [97, 70], [71, 68]]},
                    {"description": "far away", "vertices":
                     [[500, 500], [600, 500], [600, 520], [500, 520]]},
                ] if i % 4 else []}))
    (folder / "captions.json").write_text(json.dumps(captions))
    return {"vinvl": str(folder / "vinvl.tsv"), "ocr": str(ocr_dir),
            "captions": str(folder / "captions.json")}


def feature_module_dict(files):
    return {
        "LoadVinVLFeatures": {"type": "LoadVinVLFeatures",
                              "option": "default",
                              "config": {"train": files["vinvl"],
                                         "test": files["vinvl"]}},
        "LoadGoogleOCRFeatures": {"type": "LoadGoogleOCRFeatures",
                                  "option": "default",
                                  "config": {"train": files["ocr"],
                                             "test": files["ocr"],
                                             "combine_with_vinvl": True}},
        "LoadOscarCaptionFeatures": {"type": "LoadOscarCaptionFeatures",
                                     "option": "default",
                                     "config": {"train": files["captions"]}},
    }


def load_features(loader_cls, attr_dict, config, files):
    loader = loader_cls(config)
    for name, module in feature_module_dict(files).items():
        getattr(loader, name)(attr_dict(module))
    return loader


def cache_files(config):
    folder = config.cache.default_folder
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as fh:
            out[name] = pickle.load(fh)
    return out


def test_feature_modules_equal_jax(tmp_path):
    """vinvl_features (the OCR merged in, with each box's scores and each
    image's count), ocr_features and caption_features equal JAX's exactly,
    and so do the cache files; a second load reads the caches."""
    files = write_features(tmp_path / "features",
                           [str(1000 + i) for i in range(8)])
    jconfig = base_config(tmp_path / "jax")
    tconfig = TAttrDict(copy.deepcopy(base_config(tmp_path / "port")))
    jloader = load_features(JaxLoader, JAttrDict, jconfig, files)
    tloader = load_features(PortLoader, TAttrDict, tconfig, files)
    for key in ("vinvl_features", "ocr_features", "caption_features"):
        assert tloader.data[key] == jloader.data[key], key
    merged = tloader.data.vinvl_features
    assert sum(p["ocr"] for p in merged.values()) > 0
    scores = [o["score"] for p in merged.values() for obj in p["objects"]
              for o in obj.get("ocr", [])]
    assert scores and all(0 < s <= 1 for s in scores)
    # "STOP NOW i" lies inside the sign and (for small i) the nested plate
    assert any(len(p["objects"][1].get("ocr", [])) for p in merged.values())
    assert all("\n" not in o["text"] for p in merged.values()
               for obj in p["objects"] for o in obj.get("ocr", []))
    assert all("ocr" not in p["objects"][3] for p in merged.values())
    jcache, tcache = cache_files(jconfig), cache_files(tconfig)
    assert sorted(tcache) == sorted(jcache) == [
        "ocr_feature_preprocessed.pkl", "vinvl_feature_preprocessed.pkl"]
    assert tcache == jcache
    again = load_features(PortLoader, TAttrDict, tconfig, files)
    assert again.data.vinvl_features == merged


def okvqa_configs(tmp_path, n_val=5):
    """The e2e test configs turned into an OK-VQA run: LoadOKVQAData on
    the VQA2-format files, the three feature modules, and
    compute_okvqa_scores."""
    jconfig, tconfig = configs(tmp_path, n_val=n_val)
    image_keys = [str(2000 + i) for i in range(n_val)]
    files = write_features(tmp_path / "features", image_keys)
    for config, attr in ((jconfig, JAttrDict), (tconfig, TAttrDict)):
        modules = config.data_loader.dataset_modules
        modules.module_dict.LoadOKVQAData = attr(
            type="LoadOKVQAData", option="default",
            config=copy.deepcopy(modules.module_dict.LoadVQA2Data.config))
        for name, module in feature_module_dict(files).items():
            modules.module_dict[name] = attr(module)
        modules.module_list = ["LoadClipEmbeddings", "LoadInContextExamples",
                               *FEATURE_MODULES, "LoadOKVQAData"]
        config.metrics = [attr(name="compute_okvqa_scores"),
                          attr(name="write_predictions_to_file")]
    return jconfig, tconfig


def test_okvqa_eval_equals_jax(tmp_path):
    """LoadOKVQAData plus compute_okvqa_scores through the executor: the
    generated tokens, answers.pkl and every accuracy key equal JAX's; the
    split lands in data.okvqa_data (and data.vqa_data) with the okvqa
    cache names."""
    jconfig, tconfig = okvqa_configs(tmp_path)
    jrun, trun = run_both(jconfig, tconfig)
    assert_same_eval(jrun, trun, jconfig, tconfig, 5)
    tmetrics, jmetrics = trun[2], jrun[2]
    keys = sorted(k for k in tmetrics if "accuracy" in k)
    assert "test_evaluation/accuracy_overall" in keys
    assert any("AnswerType" in k for k in keys)
    assert keys == sorted(k for k in jmetrics if "accuracy" in k)
    data = trun[0].data_loader.data
    assert data.okvqa_data is data.vqa_data
    assert "vqa2_data" not in data
    assert data.vinvl_features == jrun[0].data_loader.data.vinvl_features
    assert sorted(os.listdir(tconfig.cache.default_folder)) == [
        "clip_embeddings.pkl", "ocr_feature_preprocessed.pkl",
        "okvqa_data_val_data_preprocessed.pkl",
        "vinvl_feature_preprocessed.pkl"]
    assert len(answers(tconfig)) == 5


def test_vqa2_data_keeps_its_cache_names(tmp_path):
    """LoadVQA2Data on the shared loader: data.vqa2_data, and the
    reference's cache name for its split."""
    _, tconfig = configs(tmp_path, n_val=3)
    from explicit_alignment_for_vqa_tasks_tpu_torch.registry import (
        DATA_LOADERS,
    )
    loader = DATA_LOADERS.get(tconfig.data_loader.type)(tconfig)
    loader.build_dataset()
    assert loader.data.vqa2_data is loader.data.vqa_data
    assert "okvqa_data" not in loader.data
    assert "val_data_preprocessed.pkl" in os.listdir(
        tconfig.cache.default_folder)
    assert len(loader.data.vqa_data.val.data_items) == 3
