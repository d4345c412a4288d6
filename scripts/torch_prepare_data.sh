#!/usr/bin/env bash
# Training data for the PyTorch port (H100): raw Hypersim HDF5 scenes -> tone-mapped RGB and mm depth PNGs
# with the split CSV, then VKITTI2 depth -> D2NT v3 normals (vkitti_DAG_normals). The Hypersim reader takes
# each frame's normals from $HYPERSIM_ROOT/normals/<scene>/images/scene_cam_00_geometry_preview/, which is
# linked there from the raw scenes. DEVICE=cpu runs both steps on the host.
set -e
RAW="${HYPERSIM_RAW_DIR:-data/hypersim_raw}"
OUT="${HYPERSIM_ROOT:-data/hypersim}"
python -m diffusion_e2e_ft_tpu_torch.cli.preprocess_hypersim \
  --hypersim_raw_dir "$RAW" \
  --output_dir "$OUT" \
  --device "${DEVICE:-cuda}"
for scene in "$RAW"/*/; do
  preview="${scene}images/scene_cam_00_geometry_preview"
  if [ -d "$preview" ]; then
    mkdir -p "$OUT/normals/$(basename "$scene")/images"
    ln -sfn "$(realpath "$preview")" "$OUT/normals/$(basename "$scene")/images/scene_cam_00_geometry_preview"
  fi
done
python -m diffusion_e2e_ft_tpu_torch.cli.gen_vkitti_normals \
  --vkitti_root "${VKITTI_ROOT:-data/virtual_kitti_2}" \
  --device "${DEVICE:-cuda}"
