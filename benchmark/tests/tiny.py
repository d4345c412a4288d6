"""A root with tiny cells of both families, made from the real files by
shrinking widths and depths: the harness runs them on the CPU in seconds.
Everything is added as files (a config, a traffic mix, a cell's limits, an
entry of BENCHMARK.json), as a later change would add a cell."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

TINY_UNET = {"block_out_channels": [32, 64, 64, 64], "attention_head_dim": [2, 2, 2, 2], "cross_attention_dim": 32,
             "norm_num_groups": 4}
TINY_VAE = {"block_out_channels": [8, 16, 16, 16], "layers_per_block": 1, "norm_num_groups": 4}
TINY_CLIP = {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
             "patch_size": 32, "projection_dim": 32}


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    cfg["name"] = f"tiny_{name}"
    cfg["unet"].update(TINY_UNET)
    cfg["vae"].update(TINY_VAE)
    if "image_encoder" in cfg:
        cfg["image_encoder"].update(TINY_CLIP)
    if "text_context_shape" in cfg:
        cfg["text_context_shape"] = [1, 4, 32]
    cfg["serve"].update(processing_res=32, dtype="float32")  # the CPU runs the program's plain float32 path
    cfg["train"]["dtype"] = "float32"
    return cfg


TRAFFIC = {
    "tiny_serve": {"kind": "serve", "params": {"rate": 1000.0, "shapes": [[24, 32], [24, 32], [24, 32], [32, 32]], "pool": 2,
                                                "warmup": 1, "check": [[[24, 32], 2], [[32, 32], 1]]}},
    "tiny_closed": {"kind": "serve", "params": {"shapes": [[24, 32], [24, 32], [24, 32], [32, 32]], "pool": 2,
                                                 "warmup": 1, "check": [[[24, 32], 2], [[32, 32], 1]]}},
    "tiny_train": {"kind": "train", "params": {"micro_batch": 2, "accumulation": 2, "height": 32, "width": 32,
                                               "ring": 2, "invalid_share": 0.1, "reference_rows": 1}},
}
LIMITS = {"serve": {"depth_mae": 1e-3}, "geo_serve": {"depth_mae": 1e-3, "normal_median_deg": 0.5},
          "train": {"loss_gap": 1e-3, "grad_median_gap": 1e-3, "update_gap": 1e-3}}
CELLS = [  # (cell, config, traffic, limits)
    ("tiny_marigold_serve", "marigold_e2eft_depth", "tiny_serve", "serve"),
    ("tiny_geowizard_serve", "geowizard_e2eft", "tiny_closed", "geo_serve"),
    ("tiny_marigold_train", "marigold_e2eft_depth", "tiny_train", "train"),
    ("tiny_geowizard_train", "geowizard_e2eft", "tiny_train", "train"),
]


def make_root(tmp: Path, extra_metric: str = "") -> Path:
    """A root holding the real BENCHMARK.json's metrics and the tiny cells, the
    real metric readers, and (named `extra_metric`) one more that reads the
    window's seconds."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "benchmark").mkdir(parents=True)
    shutil.copytree(BENCH_DIR / "metrics", tmp / "benchmark" / "metrics")
    for sub in ("configs", "traffic", "workloads"):
        (tmp / "benchmark" / sub).mkdir()
    bench["configs"], bench["workloads"] = [], []
    for cfg_name in ("marigold_e2eft_depth", "geowizard_e2eft"):
        cfg = tiny_config(cfg_name)
        path = f"benchmark/configs/{cfg['name']}.json"
        (tmp / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": path, "reduced": [],
                                 "why": "tiny"})
    for name, traffic in TRAFFIC.items():
        (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    names = [c[0] for c in CELLS]
    for cell, cfg_name, traffic, limits in CELLS:
        bench["workloads"].append({"name": cell, "config": f"tiny_{cfg_name}", "traffic": traffic, "chips": 1,
                                   "why": "tiny"})
        (tmp / "benchmark" / "workloads" / f"{cell}.json").write_text(json.dumps({"limits": LIMITS[limits]}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "serve" if any("serve" in w for w in m["workloads"]) else "train"
            m["workloads"] = [n for n in names if kind in n]
    if extra_metric:
        bench["per_layer"].append({"name": extra_metric, "unit": "s", "better": "lower", "source": "host_clock",
                                   "layer": "whole request", "moves": "requests_per_s",
                                   "workloads": ["tiny_marigold_serve"]})
        (tmp / "benchmark" / "metrics" / f"{extra_metric}.py").write_text(
            'SOURCE, UNIT, BETTER, MOVES, LAYER = "host_clock", "s", "lower", "requests_per_s", "whole request"\n\n\n'
            "def read(rec):\n    return rec['window_s']\n")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def copy_cell(root: Path) -> dict:
    return copy.deepcopy(json.loads((root / "BENCHMARK.json").read_text()))
