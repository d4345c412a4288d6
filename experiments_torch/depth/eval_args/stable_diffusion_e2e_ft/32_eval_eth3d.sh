#!/usr/bin/env bash
# Metric evaluation for eth3d (least-squares alignment, 10-metric set).
# The PyTorch port's twin of experiments/depth/eval_args/stable_diffusion_e2e_ft/32_eval_eth3d.sh: the same arguments, on DEVICE (default cuda).
set -e
python -m diffusion_e2e_ft_tpu_torch.cli.eval_depth \
  --dataset_config config/dataset/data_eth3d.yaml \
  --base_data_dir "${BASE_DATA_DIR:-data}" \
  --prediction_dir output/depth/stable_diffusion_e2e_ft/eth3d/prediction \
  --output_dir output/depth/stable_diffusion_e2e_ft/eth3d/eval_metric \
  --alignment least_square \
  --device "${DEVICE:-cuda}"
