"""Preprocess raw Hypersim HDF5 scenes into the training layout (offline), port
of `diffusion_e2e_ft_tpu/cli/preprocess_hypersim.py`.

As Marigold's `script/dataset_preprocess/hypersim/preprocess_hypersim.py`:
tone-mapped RGB pngs, uint16 mm depth pngs (planar depth from distance), and
the per-split CSV the Hypersim training loader reads. The frames are
computed on `--device` (default cuda); the CSV is written with the `csv`
module, in the columns and format of pandas' `to_csv(index=False)`.

    python -m diffusion_e2e_ft_tpu_torch.cli.preprocess_hypersim \\
        --hypersim_raw_dir data/hypersim_raw --output_dir data/hypersim
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

from diffusion_e2e_ft_tpu_torch.cli.common import add_device_argument, make_parser, resolve_device


def build_parser():
    p = make_parser(__doc__)
    p.add_argument("--hypersim_raw_dir", required=True, help="directory of ai_XXX_XXX scenes")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--camera", default="cam_00")
    p.add_argument("--split_csv_name", default="filename_meta_train.csv")
    add_device_argument(p, "the preprocessing")
    return p


def write_csv(path: str, rows: List[Dict[str, object]]) -> None:
    """Rows as pandas' `DataFrame(rows).to_csv(path, index=False)` writes
    them: a header of the first row's keys, `\\n` line ends, minimal quoting,
    booleans as True / False; an empty table is one empty line."""
    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        writer = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def main(argv=None):
    from diffusion_e2e_ft_tpu_torch.tools.hypersim_preprocess import preprocess_scene_hdf5

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    out_train = os.path.join(args.output_dir, "train")
    rows = []
    scenes = sorted(
        d for d in os.listdir(args.hypersim_raw_dir)
        if os.path.isdir(os.path.join(args.hypersim_raw_dir, d))
    )
    for scene in scenes:
        rows.extend(
            preprocess_scene_hdf5(
                os.path.join(args.hypersim_raw_dir, scene), out_train, camera=args.camera, device=device
            )
        )
    os.makedirs(os.path.join(args.output_dir, "processed", "train"), exist_ok=True)
    csv_path = os.path.join(args.output_dir, "processed", "train", args.split_csv_name)
    write_csv(csv_path, rows)
    print(f"[hypersim] {len(rows)} frames -> {csv_path}")
    return csv_path


if __name__ == "__main__":
    main()
