"""Dataset image/timestamp reading (reference: src/ImageReader.cpp).

Scans a directory for .png/.jpg images (sorted), reads grayscale, resizes to
the camera's size, and parses timestamp files in the reference's four line
formats (ImageReader.cpp:26-60):

    1. "<stamp> x y z a b c d"     (TUM groundtruth-like, 8 fields)
    2. "<id> <stamp> <exposure>"   (TUM MonoVO times file)
    3. "<id> <stamp>"
    4. "<stamp>"
"""

from __future__ import annotations

import os

import numpy as np


def _parse_stamp_line(line: str) -> str | None:
    tok = line.split()
    if not tok:
        return None
    if len(tok) >= 8:
        return tok[0]
    if len(tok) in (2, 3):
        return tok[1]
    return tok[0]


class ImageReader:
    def __init__(self, image_folder: str, size_wh: tuple[int, int],
                 time_file: str | None = None):
        exts = (".png", ".jpg", ".jpeg", ".bmp")
        self.files = sorted(
            os.path.join(image_folder, f)
            for f in os.listdir(image_folder)
            if f.lower().endswith(exts)
        )
        self.size_wh = size_wh
        self.stamps: list[str] = []
        if time_file and time_file != "None":
            with open(time_file) as fh:
                for line in fh:
                    s = _parse_stamp_line(line)
                    if s is not None:
                        self.stamps.append(s)
        self.stamp_valid = len(self.stamps) >= len(self.files) and len(self.files) > 0

    def __len__(self) -> int:
        return len(self.files)

    def read_image(self, i: int) -> np.ndarray:
        try:
            import cv2  # decoding only; the tracking path never needs it
        except ImportError as e:
            raise ImportError(
                "reading dataset images needs OpenCV (the cv2 module); "
                "install opencv-python or pass decoded frames to "
                "FrameHandler.add_image") from e
        img = cv2.imread(self.files[i], cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(f"failed to read {self.files[i]}")
        if (img.shape[1], img.shape[0]) != self.size_wh:
            img = cv2.resize(img, self.size_wh, interpolation=cv2.INTER_LINEAR)
        return img

    def read_stamp(self, i: int) -> str:
        return self.stamps[i] if self.stamp_valid else str(i)
