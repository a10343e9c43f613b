from .gru import gru_layer_single_direction, bigru, flip_padded, gru_cell_step
from .pooling import attn_pool, masked_mean_pool, length_mask
from .nn import (
    dense,
    layer_norm,
    conv2d_nhwc,
    conv1d_nwc,
    max_pool_2x2,
    uniform_init,
    linear_init,
    conv_init,
    gru_dir_init,
)
from .features import (
    extract_features_batched,
    extract_features_frame,
    mouth_width,
    lip83_features_batched,
)
from .roi import crop_resize_gray_batched, resize_matrices, make_resize_matrix
from .ctc import ctc_loss, ctc_word_logprob, ctc_word_logprobs_batch

__all__ = [
    "gru_layer_single_direction",
    "bigru",
    "flip_padded",
    "gru_cell_step",
    "attn_pool",
    "masked_mean_pool",
    "length_mask",
    "dense",
    "layer_norm",
    "conv2d_nhwc",
    "conv1d_nwc",
    "max_pool_2x2",
    "uniform_init",
    "linear_init",
    "conv_init",
    "gru_dir_init",
    "extract_features_batched",
    "extract_features_frame",
    "mouth_width",
    "lip83_features_batched",
    "crop_resize_gray_batched",
    "resize_matrices",
    "make_resize_matrix",
    "ctc_loss",
    "ctc_word_logprob",
    "ctc_word_logprobs_batch",
]

from .gru import unidirectional_gru_chunked  # noqa: E402
from .features import (  # noqa: E402
    mouth83_features_batched,
    polygon_area,
    v3_features_batched,
)

__all__ += [
    "unidirectional_gru_chunked",
    "mouth83_features_batched",
    "polygon_area",
    "v3_features_batched",
]
