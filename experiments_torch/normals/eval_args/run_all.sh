#!/usr/bin/env bash
# Full 4-dataset surface-normal benchmark for all three E2E-FT model families, on the PyTorch port
# (twin of experiments/normals/eval_args/run_all.sh). DEVICE picks the device (default cuda; cpu on a
# box without a card). Where set, CHECKPOINT_<family> (e.g. CHECKPOINT_marigold_e2e_ft), BASE_DATA_DIR,
# EVAL_DATA (space-separated) and SPLIT_PATHS (NAME=PATH ...) replace the argument files' values.
# Relative paths resolve from the working directory, the repository root by default.
set -e
here="$(dirname "$0")"
for args in "$here"/*.txt; do
  checkpoint="CHECKPOINT_$(basename "$args" .txt)"
  python -m diffusion_e2e_ft_tpu_torch.cli.eval_normals @"$args" --device "${DEVICE:-cuda}" \
    ${!checkpoint:+--checkpoint "${!checkpoint}"} ${BASE_DATA_DIR:+--base_data_dir "$BASE_DATA_DIR"} \
    ${EVAL_DATA:+--eval_data $EVAL_DATA} ${SPLIT_PATHS:+--split_paths $SPLIT_PATHS}
done
