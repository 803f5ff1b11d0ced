"""Vertical chunking of tall pages (the port's copy of
surya_tpu/detection/util.py; reference: surya/detection/util.py:7-37)."""

import math

from PIL import Image, ImageOps

from surya_tpu_torch.settings import settings


def get_total_splits(image_size, height: int) -> int:
    img_height = image_size[1]
    if img_height > settings.DETECTOR_IMAGE_CHUNK_HEIGHT:
        return math.ceil(img_height / height)
    return 1


def split_image(img: Image.Image, height: int):
    """Crop a tall page into `height`-px chunks, padding the last with white.
    Returns (chunks, chunk_heights); never mutates the input image."""
    img_height = img.size[1]
    if img_height <= settings.DETECTOR_IMAGE_CHUNK_HEIGHT:
        return [img.copy()], [img_height]

    num_splits = math.ceil(img_height / height)
    splits, split_heights = [], []
    for i in range(num_splits):
        top = i * height
        bottom = min((i + 1) * height, img_height)
        cropped = img.crop((0, top, img.size[0], bottom))
        chunk_height = bottom - top
        if chunk_height < height:
            # white padding (the reference's color=255 pads an RGB image red)
            cropped = ImageOps.pad(cropped, (img.size[0], height), color=(255, 255, 255), centering=(0, 0))
        splits.append(cropped)
        split_heights.append(chunk_height)
    return splits, split_heights
