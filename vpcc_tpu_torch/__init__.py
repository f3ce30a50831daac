"""vpcc_tpu_torch — V-PCC on PyTorch with hand-written CUDA kernels: the
decoder and the encoder.

A port of the `vpcc_tpu` package (JAX) to PyTorch on an NVIDIA H100.  It
imports neither JAX nor `vpcc_tpu`: host code it needs is copied here.  The
JAX package stays the reference the port is tested against.

Layout (mirrors vpcc_tpu/):
    device.py   device policy, CUDA kernel build/load, launch counters
    csrc/       CUDA C++ kernels (built with nvcc for sm_90a at first use)
    bitstream/  V3C high-level syntax reader and writer + bit I/O
    video/      host entropy coding (ctypes), wavefront video encoder and
                decoder, color conversion, substream encoders and decoders,
                the lossless plane codec and the RAW/EOM aux packing
    core/       patch data model and patch building, packing, atlas frames,
                block-to-patch
    ops/        voxelize, grid k-NN, normals, segmentation, connected
                components, coverage, point reconstruction, grid smoothing,
                color smoothing and pre-smoothing, PBF (pbf.py), PLR
                (plr.py), push-pull fill, recolor, metrics
    pipeline.py the reconstruction seam (PBF, points, smoothing, color
                gather, the EOM rows' colors, color smoothing) and the
                attribute images (paint, group dilation)
    decoder.py  `Decoder.decode` — V3C stream -> point clouds
    encoder.py  `Encoder.encode_gof` — point clouds -> V3C stream and the
                encoder-side reconstructions (its stages are public too)
    carry.py    state carried across frames (config, reference planes,
                a tree parent's patch list, the GOF height ratchet)
    apps/       CLI drivers

Entry points run on CUDA unless the caller passes `device="cpu"`; on the CPU
every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from vpcc_tpu_torch import device  # noqa: F401  (sets the numeric policy)
from vpcc_tpu_torch.utils.config import VPCCConfig  # noqa: F401


def __getattr__(name):
    # `vpcc_tpu_torch.Decoder` without importing the decoder at package
    # import time (keeps `import vpcc_tpu_torch` cheap)
    if name == "Decoder":
        from vpcc_tpu_torch.decoder import Decoder

        return Decoder
    raise AttributeError(name)
