import os

import cv2
import numpy as np
from scipy.spatial.transform import Rotation

from hso_tpu.cameras import EquidistantCamera, FOVCamera, PinholeCamera
from hso_tpu.io.calib import parse_calib
from hso_tpu.io.image_reader import ImageReader, _parse_stamp_line
from hso_tpu.io.trajectory import rotation_to_quaternion

REF_CAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data", "cameras")


def test_parse_euroc_calib():
    cam = parse_calib(os.path.join(REF_CAMS, "euroc.txt"))
    assert isinstance(cam, PinholeCamera)
    assert (cam.width, cam.height) == (752, 480)
    assert abs(cam.fx - 458.654) < 1e-3
    assert cam.has_distortion and not cam.undistort_image


def test_parse_icl_calib():
    cam = parse_calib(os.path.join(REF_CAMS, "icl-nuim.txt"))
    assert isinstance(cam, PinholeCamera)
    assert not cam.has_distortion


def test_parse_fov_calibs():
    cam_n = parse_calib(os.path.join(REF_CAMS, "tum_mono_vo_narrow.txt"))
    assert isinstance(cam_n, FOVCamera)
    # 1280x1024 > max resolution: resized, normalized intrinsics scale by size
    assert cam_n.width * cam_n.height <= 848 * 800
    cam_w = parse_calib(os.path.join(REF_CAMS, "tum_mono_vo_wide.txt"))
    assert isinstance(cam_w, FOVCamera)


def test_stamp_line_formats():
    assert _parse_stamp_line("1403636579.76 0 0 0 0 0 0 1") == "1403636579.76"
    assert _parse_stamp_line("7 1403636579.76 0.05") == "1403636579.76"
    assert _parse_stamp_line("7 1403636579.76") == "1403636579.76"
    assert _parse_stamp_line("1403636579.76") == "1403636579.76"
    assert _parse_stamp_line("") is None


def test_image_reader_roundtrip(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(d / f"{i:03d}.png"),
                    rng.integers(0, 255, (120, 160), dtype=np.uint8))
    times = tmp_path / "times.txt"
    times.write_text("".join(f"{i} {100.5 + i}\n" for i in range(3)))
    r = ImageReader(str(d), (80, 60), str(times))
    assert len(r) == 3 and r.stamp_valid
    img = r.read_image(1)
    assert img.shape == (60, 80)
    assert r.read_stamp(2) == "102.5"


def test_quaternion_roundtrip():
    rng = np.random.default_rng(1)
    for _ in range(20):
        R = Rotation.random(random_state=rng).as_matrix()
        q = rotation_to_quaternion(R)
        R2 = Rotation.from_quat(q).as_matrix()
        np.testing.assert_allclose(R2, R, atol=1e-9)
