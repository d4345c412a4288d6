#!/usr/bin/env bash
# Inference dump for eth3d with the geowizard_e2e_ft checkpoint (1-step, zeros noise, trailing).
# The PyTorch port's twin of experiments/depth/eval_args/geowizard_e2e_ft/31_infer_eth3d.sh: the same arguments, on DEVICE (default cuda).
set -e
python -m diffusion_e2e_ft_tpu_torch.cli.infer \
  --checkpoint "${CHECKPOINT:-GonzaloMG/geowizard-e2e-ft}" \
  --model_type geowizard \
  --dataset_config config/dataset/data_eth3d.yaml \
  --base_data_dir "${BASE_DATA_DIR:-data}" \
  --output_dir output/depth/geowizard_e2e_ft/eth3d/prediction \
  --denoise_steps 1 --ensemble_size 1 --noise zeros --processing_res 0 \
  --seed 1234 \
  --device "${DEVICE:-cuda}"
