#!/usr/bin/env bash
# Multi-step diffusion-estimator baseline: 50-step DDIM, ensemble 10, pyramid noise
# (exercises the scheduler scan + BFGS depth ensembling off the 1-step fast path).
# The PyTorch port's twin of experiments/depth/eval_args/marigold_diffusion_baseline/11_infer_nyu.sh: the same arguments, on DEVICE (default cuda).
set -e
python -m diffusion_e2e_ft_tpu_torch.cli.infer \
  --checkpoint "${CHECKPOINT:-prs-eth/marigold-v1-0}" \
  --model_type marigold \
  --dataset_config config/dataset/data_nyu_test.yaml \
  --base_data_dir "${BASE_DATA_DIR:-data}" \
  --output_dir output/depth/marigold_diffusion_baseline/nyu_test/prediction \
  --denoise_steps 50 --ensemble_size 10 --noise pyramid --processing_res 0 \
  --timestep_spacing trailing \
  --seed 1234 \
  --device "${DEVICE:-cuda}"
