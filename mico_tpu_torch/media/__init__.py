"""Host media decode and preprocessing (counterpart of `mico_tpu/media/`)."""

from mico_tpu_torch.media.processors import (
    AudioProcessor,
    ImageProcessor,
    VideoProcessor,
    CLIP_MEAN,
    CLIP_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from mico_tpu_torch.media.chunking import sample_chunk_indices, split_chunks
