"""Generate VKITTI GT surface normals from GT depth (offline, once per dataset),
port of `diffusion_e2e_ft_tpu/cli/gen_vkitti_normals.py`.

Walks `vkitti_2.0.3_depth`, runs the D2NT v3 pipeline (DAG gradients + MRF)
in torch on `--device` (default cuda), and writes the 16-bit
`vkitti_DAG_normals` pngs the training loader consumes.

    python -m diffusion_e2e_ft_tpu_torch.cli.gen_vkitti_normals --vkitti_root data/virtual_kitti_2
"""

from __future__ import annotations

from diffusion_e2e_ft_tpu_torch.cli.common import add_device_argument, make_parser, resolve_device
from diffusion_e2e_ft_tpu_torch.tools.depth_to_normal import generate_vkitti_normals


def build_parser():
    p = make_parser(__doc__)
    p.add_argument("--vkitti_root", default="data/virtual_kitti_2")
    p.add_argument("--version", choices=["basic", "v2", "v3"], default="v3")
    add_device_argument(p, "the translation")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    n = generate_vkitti_normals(args.vkitti_root, version=args.version, device=resolve_device(args.device))
    print(f"[d2n] generated normals for {n} frames")
    return n


if __name__ == "__main__":
    main()
