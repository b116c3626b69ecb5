"""buildingsegment_tpu — a JAX building point-cloud segmentation framework.

A JAX/XLA implementation of the capabilities of the
reference C++ tool ``little-little-point-cloud-group/buildingSegment``
(``tmc3``): load a building LiDAR PLY scan, quantize positions to integer
millimeters, estimate per-point normals and a k-nearest-neighbor graph,
grow planar segments (walls / roofs / ground), write a color-labeled PLY,
and optionally rasterize ortho height/density PNGs, extract building
contours and extrude them to an OBJ prism model.

Unlike the reference (single-threaded CPU, KD-trees, recursive seed
queues — see SURVEY.md), scans here are padded fixed-capacity point
tensors, the hot per-point stages run as fused on-device kernels
(tiled kNN, covariance-PCA normals, fixed-point label-propagation region
growing, scatter-add rasterization), and large scans shard over a
device mesh with XLA collectives.

Public entry points:
    - :mod:`buildingsegment_tpu.pipeline` — end-to-end segmentation
    - :mod:`buildingsegment_tpu.cli` — reference-compatible ``-a= -s=`` CLI
    - :mod:`buildingsegment_tpu.io.ply` — PLY codec
"""

from buildingsegment_tpu.config import PipelineConfig

__version__ = "0.1.0"

__all__ = ["PipelineConfig", "__version__"]
