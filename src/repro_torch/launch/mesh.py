"""Production meshes of the PyTorch port (counterpart of
`repro.launch.mesh`), as `torch.distributed` device meshes.

single-pod: 256 ranks as (data=16, model=16)
multi-pod:  512 ranks as (pod=2, data=16, model=16)

These keep the JAX package's axis names and shapes, so the dry run
partitions exactly what the reference partitions, not an HGX H100
node's natural (32, 8): a 16-wide "model" axis spans two 8-GPU nodes,
so its collectives leave NVLink for the inter-node network.

FUNCTIONS, not module constants: importing this module touches no
process group. `init_device_mesh` needs an initialized default group
whose world size is the mesh's size (the dry run uses a fake one).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(n: int = 8, device_type: str = "cpu"):
    """A small (n // 4, 4) ("data", "model") mesh over an n-rank group
    (the tests' gloo or fake groups)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n // 4, 4),
                            mesh_dim_names=("data", "model"))


# Hardware constants for the roofline: one NVIDIA H100 SXM5 80GB at its
# 700 W limit (NVIDIA H100 Tensor Core GPU datasheet; Hopper tuning guide
# for shared memory).
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12                  # HBM3 bytes/s per GPU
NVLINK_BW = 450e9                 # NVLink 4, bytes/s per direction per GPU
SMEM_BYTES = 228 * 2 ** 10        # shared memory per SM (VMEM's place)
HBM_BYTES = 80 * 2 ** 30          # device memory per GPU
