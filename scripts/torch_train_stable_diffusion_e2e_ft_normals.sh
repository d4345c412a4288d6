#!/usr/bin/env bash
# Stable Diffusion + E2E FT, normals
# The PyTorch port (H100); BASE_MODEL is a local HF pipeline directory (the port downloads nothing)
set -e
python -m diffusion_e2e_ft_tpu_torch.cli.train \
  --pretrained_model_name_or_path "${BASE_MODEL:-stabilityai/stable-diffusion-2}" \
  --modality normals \
  --noise_type zeros \
  --train_batch_size 2 \
  --gradient_accumulation_steps 16 \
  --gradient_checkpointing \
  --max_train_steps 20000 \
  --checkpointing_steps 20000 \
  --learning_rate 3e-05 \
  --lr_total_iter_length 20000 \
  --lr_warmup_steps 100 \
  --hypersim_root "${HYPERSIM_ROOT:-data/hypersim}" \
  --vkitti_root "${VKITTI_ROOT:-data/virtual_kitti_2}" \
  --output_dir "model-finetuned/${RUN_NAME:-stable_diffusion_e2e_ft_normals}"
