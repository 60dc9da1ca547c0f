"""The entry points a user runs: ``bench.py`` and ``chip_smoke.py`` refuse
to measure off the GPU, nothing on the main path needs OpenCV, and the
compile cache honours ``JAX_COMPILATION_CACHE_DIR``."""

import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code: str, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_main_path_imports_without_cv2():
    out = _python(
        "import sys; sys.modules['cv2'] = None\n"
        "import bench, chip_smoke\n"
        "from hso_tpu.utils.synthetic import BoxScene, PlaneScene\n"
        "from hso_tpu.cameras import PinholeCamera\n"
        "cam = PinholeCamera(64, 48, 40.0, 40.0, 32.0, 24.0)\n"
        "img = PlaneScene(cam, tex_size=64).render()\n"
        "img2 = BoxScene(cam, tex_size=64).render()\n"
        "assert img.shape == img2.shape == (48, 64) and img.std() > 0\n"
        "print('ok')\n",
        {"JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(tmp_path, env_set):
    code = ("from hso_tpu.utils.jax_cache import enable_compile_cache\n"
            "import jax\n"
            "p = enable_compile_cache()\n"
            "print(p); print(jax.config.jax_compilation_cache_dir)\n")
    if env_set:
        out = _python(code, {"JAX_PLATFORMS": "cpu",
                             "JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        want = str(tmp_path)
    else:
        out = _python(code, {"JAX_PLATFORMS": "cpu"},
                      drop=("JAX_COMPILATION_CACHE_DIR",))
        want = os.path.join(ROOT, ".jax_cache")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [want, want]


def test_bench_refuses_cpu_without_flag():
    out = _python("import bench; bench.main([])", {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert "'cpu'" in out.stderr and "--cpu" in out.stderr
    assert out.stdout == ""


def test_chip_smoke_main_exits_nonzero_on_cpu(capsys):
    import chip_smoke

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.main()
    assert e.value.code != 0
    out = capsys.readouterr()
    assert "'cpu'" in out.err and '"ok"' not in out.out
