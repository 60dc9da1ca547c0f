"""``chip_smoke.py``'s kernel and pipeline phases on the CPU at reduced
sizes (the card runs them at full width), and the trace reduction."""

import jax
import pytest

import chip_smoke


def test_kernels_phase_reduced():
    cpu = jax.devices("cpu")[0]
    checks = chip_smoke.phase_kernels(cpu, cpu, n_seeds=64, n_feat=40)
    names = " ".join(c[0] for c in checks)
    for stage in ("extract_windows", "pack_level_windows", "ZMNCC",
                  "match_points", "coarse tracker FC", "coarse tracker IC",
                  "pose LM", "retry ids"):
        assert stage in names
    # one device against itself: every stage reproduces exactly
    assert all(err == 0.0 or err < 1e-6 for _, err, _ in checks), checks


def test_pipeline_phase_reduced():
    vo, _, rmse = chip_smoke.phase_pipeline(n_frames=40, min_kfs=3)
    assert vo.stage == "default"
    assert rmse <= 2.0 * chip_smoke.CPU_PIPELINE_RMSE_M + 1e-3


def test_trace_reduction_on_recorded_events():
    """A hand-written event list in the shape a GPU trace has: two
    iterations of one loop (predicate copies of 1 byte), a kernel after the
    loop exits, and a larger device-to-host copy."""
    pred = {"memcpy_details": "kind_src:device kind_dst:pinned size:1 dest:0",
            "hlo_module": "jit_step", "hlo_op": "while.7"}
    evs = [
        (0, 10, "fusion_a", {}),
        (10, 11, "MemcpyD2H", pred),            # iteration 1 starts
        (11, 31, "fusion_body", {}),
        (31, 32, "MemcpyD2H", pred),            # iteration 2 starts
        (32, 62, "fusion_body", {}),
        (62, 63, "MemcpyD2H", pred),            # predicate false: exit
        (63, 73, "fusion_after", {}),
        (73, 80, "MemcpyD2H", {"memcpy_details": "size:96 "}),
        (80, 100, "MemcpyH2D", {}),
    ]
    s = chip_smoke.summarize_events(evs, n_frames=2,
                                    scopes={("jit_step", "while.7"): "pose_lm"})
    assert s["kernels_per_frame"] == 2.0          # 4 kernels / 2 frames
    assert s["d2h_copies_per_frame"] == 2.0
    assert s["kernel_ms_per_frame"] == 70 / 1e6 / 2
    assert abs(s["device_idle_share"] - 0.3) < 1e-12
    assert s["loops"] == {"pose_lm": {"iterations_per_frame": 1.5,
                                      "ms_per_frame": 50 / 1e6 / 2}}


def test_loop_scopes_from_hlo_text():
    hlo = ("  %while.3 = (f32[], s32[]) while((f32[], s32[]) %t), "
           "condition=%c, body=%b, metadata={op_name=\"jit(step)/coarse_lm/"
           "while\" source_file=\"x.py\"}\n"
           "  %while.4 = (f32[]) while((f32[]) %u), condition=%c2, body=%b2\n")
    assert chip_smoke.loop_scopes(hlo) == {"while.3": "coarse_lm"}


@pytest.mark.gpu
def test_kernels_phase_full_width_on_gpu(gpu):
    chip_smoke.phase_kernels(gpu, jax.devices("cpu")[0])
