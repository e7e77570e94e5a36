"""Kill-and-resume: the product checkpoint path (not just the npz helper).

SURVEY §5: the reference has no checkpointing; the device build owes film +
sweep-cursor checkpoints for preemption recovery.  Because samplers are
pure functions of (pixel, sample, dim), a resumed render must be
bit-identical to an uninterrupted one.
"""

import numpy as np
import pytest

from pbrt_tpu import Options
from pbrt_tpu.render import Renderer
from pbrt_tpu.testscenes import cornell_description


def _renderer(tmp, ckpt=True):
    desc, _ = cornell_description(xres=24, yres=24, spp=2, maxdepth=2)
    opt = Options(
        ray_batch=128,  # many chunks
        checkpoint_dir=str(tmp) if ckpt else None,
        checkpoint_every=1,
    )
    return Renderer(desc, opt)


def test_kill_and_resume_bit_identical(tmp_path):
    # uninterrupted reference (checkpointed mode, separate dir)
    ref_dir = tmp_path / "ref"
    r_ref = _renderer(ref_dir)
    state_ref = r_ref.render(progress=False)
    img_ref = np.asarray(r_ref.film.to_rgb(state_ref))

    # interrupted run: kill after 3 chunks
    kill_dir = tmp_path / "kill"
    r1 = _renderer(kill_dir)
    calls = {"n": 0}
    orig_step = r1._step

    def dying_step(*a, **kw):
        if calls["n"] >= 3:
            raise KeyboardInterrupt("simulated preemption")
        calls["n"] += 1
        return orig_step(*a, **kw)

    r1._step = dying_step
    with pytest.raises(KeyboardInterrupt):
        r1.render(progress=False)
    assert (kill_dir / "film.ckpt.npz").exists()

    # fresh process-equivalent: new Renderer, same scene/options -> resume
    r2 = _renderer(kill_dir)
    state2 = r2.render(progress=False)
    img2 = np.asarray(r2.film.to_rgb(state2))
    np.testing.assert_array_equal(img2, img_ref)


def test_mismatched_checkpoint_ignored(tmp_path):
    r1 = _renderer(tmp_path)
    r1.render(progress=False)
    # different spp -> metadata mismatch -> fresh render, not a crash
    desc, _ = cornell_description(xres=24, yres=24, spp=4, maxdepth=2)
    r2 = Renderer(desc, Options(ray_batch=128, checkpoint_dir=str(tmp_path)))
    state = r2.render(spp=4, progress=False)
    img = np.asarray(r2.film.to_rgb(state))
    assert np.isfinite(img).all() and img.max() > 0


def test_stats_counters_live(tmp_path):
    """render/* and scene/* counters must be populated by a real render —
    the reference only carries STAT_COUNTER TODOs (film.rs:314)."""
    from pbrt_tpu.utils import stats

    stats.reset()
    r = _renderer(tmp_path, ckpt=False)
    r.render(progress=False)
    snap = stats.snapshot()["counters"]
    assert snap.get("scene/lights", 0) >= 1
    assert snap.get("scene/triangles", 0) >= 10
    assert snap.get("render/chunks", 0) >= 1
    assert snap.get("render/camera_samples", 0) == 24 * 24 * 2
    assert "Statistics:" in stats.report()
