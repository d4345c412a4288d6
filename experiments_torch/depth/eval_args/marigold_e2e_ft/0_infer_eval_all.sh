#!/usr/bin/env bash
# Full 5-dataset depth benchmark for marigold_e2e_ft, on the PyTorch port (twin of
# experiments/depth/eval_args/marigold_e2e_ft/0_infer_eval_all.sh). The numbered scripts run from the
# working directory, the repository root, where their relative paths resolve.
set -e
here="$(dirname "$0")"
for s in $(cd "$here" && ls [0-9]*_infer_*.sh | sort -n); do bash "$here/$s"; done
for s in $(cd "$here" && ls [0-9]*_eval_*.sh | sort -n); do bash "$here/$s"; done
