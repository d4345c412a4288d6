#!/usr/bin/env bash
# Metric evaluation for diode (least-squares alignment, 10-metric set).
# The PyTorch port's twin of experiments/depth/eval_args/marigold_e2e_ft/52_eval_diode.sh: the same arguments, on DEVICE (default cuda).
set -e
python -m diffusion_e2e_ft_tpu_torch.cli.eval_depth \
  --dataset_config config/dataset/data_diode_all.yaml \
  --base_data_dir "${BASE_DATA_DIR:-data}" \
  --prediction_dir output/depth/marigold_e2e_ft/diode/prediction \
  --output_dir output/depth/marigold_e2e_ft/diode/eval_metric \
  --alignment least_square \
  --device "${DEVICE:-cuda}"
