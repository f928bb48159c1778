"""Frame extraction and grid composition (reference:
IG-VLM/vision_processor/fps_extractor.py, gridview_generator.py:15-57);
the port's own copy of ``matryoshka_mm_tpu/igvlm/grid.py``, used by the
web server's video upload and the IG-VLM pipeline.  ``cv2`` is imported
where it is used.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


def extract_frames(video_path: str, frame_fixed_number: int = 6,
                   ts: Optional[tuple] = None) -> List[np.ndarray]:
    """Uniformly sample ``frame_fixed_number`` RGB frames from a video.

    Uses cv2; ``ts=(start_s, end_s)`` restricts to a clip.
    """
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    start_f, end_f = 0, total - 1
    if ts is not None:
        start_f = int(ts[0] * fps)
        end_f = min(int(ts[1] * fps), total - 1)
    idxs = np.linspace(start_f, end_f, frame_fixed_number).round().astype(int)

    frames = []
    for idx in idxs:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    while len(frames) < frame_fixed_number:
        frames.append(frames[-1])
    return frames


def default_max_per_row(n_images: int) -> int:
    """sqrt(N) per row (reference: eval entries pass ceil(sqrt))."""
    return max(int(math.ceil(math.sqrt(n_images))), 1)


def create_grid_view(images: List[np.ndarray],
                     func_max_per_row=default_max_per_row) -> np.ndarray:
    """Compose frames into a grid, white-padding the last row
    (reference: gridview_generator.py:29-51).  RGB in, RGB out."""
    import cv2

    max_per_row = func_max_per_row(len(images))
    min_width = min(img.shape[1] for img in images)
    min_height = min(img.shape[0] for img in images)
    resized = [cv2.resize(img, (min_width, min_height)) for img in images]
    while len(resized) % max_per_row != 0:
        resized.append(np.ones((min_height, min_width, 3), np.uint8) * 255)
    rows = [resized[i:i + max_per_row]
            for i in range(0, len(resized), max_per_row)]
    return np.vstack([np.hstack(r) for r in rows])


def video_to_grid_image(video_path: str, frame_fixed_number: int = 6):
    """video file -> PIL grid image, the full IG-VLM vision front-end."""
    from PIL import Image

    frames = extract_frames(video_path, frame_fixed_number)
    return Image.fromarray(create_grid_view(frames))
