"""Stereo-matching and optical-flow downstream task family (the JAX
package's stereoflow/, after the reference's croco/stereoflow/): CroCo
binocular finetuning with a pixelwise DPT head, Laplacian confidence
losses, tiled high-resolution inference, the stereo and flow dataset zoo,
and the train and test drivers (`python -m spann3r_torch.stereoflow_train`,
`python -m spann3r_torch.stereoflow_test`).

Layout: NHWC activations; predictions are (B, H, W, C) with C = 1
(disparity) or 2 (flow), plus one confidence channel when the criterion
carries one, the reference's B x C x H x W contract transposed.
"""
from .head import PixelwiseTaskWithDPT, pixelwise_dpt_apply  # noqa: F401
from .criterion import (build_criterion, stereo_metrics,  # noqa: F401
                        flow_metrics, StereoDatasetMetrics,
                        FlowDatasetMetrics)
from .tiling import tiled_pred, tile_slices  # noqa: F401
