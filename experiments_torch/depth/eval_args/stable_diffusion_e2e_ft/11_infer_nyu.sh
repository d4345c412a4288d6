#!/usr/bin/env bash
# Inference dump for nyu with the stable_diffusion_e2e_ft checkpoint (1-step, zeros noise, trailing).
# The PyTorch port's twin of experiments/depth/eval_args/stable_diffusion_e2e_ft/11_infer_nyu.sh: the same arguments, on DEVICE (default cuda).
set -e
python -m diffusion_e2e_ft_tpu_torch.cli.infer \
  --checkpoint "${CHECKPOINT:-GonzaloMG/stable-diffusion-e2e-ft-depth}" \
  --model_type marigold \
  --dataset_config config/dataset/data_nyu_test.yaml \
  --base_data_dir "${BASE_DATA_DIR:-data}" \
  --output_dir output/depth/stable_diffusion_e2e_ft/nyu_test/prediction \
  --denoise_steps 1 --ensemble_size 1 --noise zeros --processing_res 0 \
  --seed 1234 \
  --device "${DEVICE:-cuda}"
