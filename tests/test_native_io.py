import os
import subprocess

import cv2
import numpy as np
import pytest

from hso_tpu.io import native_reader


@pytest.fixture(scope="module")
def lib_built():
    if not native_reader.native_available():
        rc = subprocess.run(
            [os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "native", "build.sh")],
            capture_output=True)
        if rc.returncode != 0:
            pytest.skip("native build failed: " + rc.stderr.decode()[-200:])
        native_reader._LIB = native_reader._load_lib()
    return True


@pytest.fixture
def dataset(tmp_path):
    rng = np.random.default_rng(0)
    imgs = []
    for i in range(12):
        img = rng.integers(0, 255, (120, 160), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"frame_{i:04d}.png"), img)
        imgs.append(img)
    return tmp_path, imgs


def test_native_random_access(lib_built, dataset):
    d, imgs = dataset
    r = native_reader.NativeImageReader(str(d), (160, 120))
    assert len(r) == 12
    np.testing.assert_array_equal(r.read_image(3), imgs[3])
    assert r.path(0).endswith("frame_0000.png")
    r.close()


def test_native_resize(lib_built, dataset):
    d, imgs = dataset
    r = native_reader.NativeImageReader(str(d), (80, 60))
    out = r.read_image(0)
    ref = cv2.resize(imgs[0], (80, 60), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(out, ref)
    r.close()


def test_native_prefetch_stream(lib_built, dataset):
    d, imgs = dataset
    r = native_reader.NativeImageReader(str(d), (160, 120), n_workers=3, depth=4)
    r.start(2, 10)
    seen = []
    for idx, img in r:
        seen.append(idx)
        np.testing.assert_array_equal(img, imgs[idx])
    assert seen == list(range(2, 10))
    r.close()
