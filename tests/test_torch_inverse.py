"""Inverse rendering: the port (pathtracer_tpu_torch.inverse) vs the JAX
package on the CPU.

Both packages get one packed scene (the port's packer, moved to each
package's arrays), one camera and one target made with numpy; the port's
scenes are on the CPU, where the intersection kernels' plain versions run.

Tolerances: losses within rtol 1e-5. Gradients: per field, the largest
difference from ``jax.grad`` at most 1e-4 of that field's largest |g| (both
packages sum the same per-path terms; libm, XLA's fused rounding and the
order of the index backward's sums differ in the last bits: ~1e-7 of max |g|
measured). The tie cases are held to the same bound, which ``torch.clamp``
misses by a factor of 2 on the tied entries. The ``mat_Ns`` gradient also
within the JAX test's finite-difference bound ``1e-4 + 0.05 |fd|``. A 3-step
Adam trajectory within 1e-5 of optax's params (each step moves a parameter by
about the learning rate, 5e-2 at most).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import inverse as jinv
from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
from pathtracer_tpu.models.scene import _to_device
from pathtracer_tpu.ops import rng as jrng
from pathtracer_tpu.ops.camera_rays import generate_rays as jax_rays
from pathtracer_tpu.ops.integrator import radiance_batch as jax_radiance
from pathtracer_tpu.ops.tonemap import tonemap_reference as jax_tonemap
from pathtracer_tpu_torch import inverse as tinv
from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import integrator, intersect_small, rng
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
from pathtracer_tpu_torch.render import render
from pathtracer_tpu_torch.utils.checkpoint import load_pytree, save_pytree

SIZE = dict(width=16, height=16, max_depth=4, scheduler="scan")
N_PIX = SIZE["width"] * SIZE["height"]
GLOSSY = 4  # material row of the glossy tall box (procedural.cornell_box_mesh)
RED = 1  # the red wall's material row
GRAD_RTOL = 1e-4  # of each field's largest |g|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch's CPU ops on one thread here: the integrator issues hundreds
    of small ops per bounce, and with test workers sharing the cores
    OpenMP's thread teams cost more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(glossy: bool = True, tied: bool = False):
    """(JAX Scene, port Scene, camera) of the procedural Cornell box.
    ``tied``: the red wall's green and blue albedo set to exactly 0, so its
    pixels' radiance sits exactly on the per-sample clamp's bound there while
    its gradient with respect to those albedos does not vanish."""
    packed = pack_scene(procedural.cornell_box_mesh(glossy_tall_box=glossy))
    if tied:
        packed.materials.Kd[RED, 1:] = 0.0
    return (_to_device(packed), scene_from_packed(packed, "cpu"),
            procedural.cornell_box_camera())


def _frames(camera, st):
    jframe = {k: jnp.asarray(v) for k, v in camera.ray_frame(st.width, st.height).items()}
    return jframe, ray_frame_tensors(camera, st.width, st.height, "cpu")


def _ids(*arrays):
    """numpy u32 ids -> (JAX arrays, port int64 tensors)."""
    return ([jnp.asarray(a, jnp.uint32) for a in arrays],
            [torch.as_tensor(a.astype(np.int64)) for a in arrays])


def _leaf_params(scene, fields=tinv.PARAM_FIELDS):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in tinv.material_params(scene, fields).items()}


def _assert_grads(got: dict, ref: dict):
    for k, r in ref.items():
        r, g = np.asarray(r), got[k].numpy()
        assert np.isfinite(g).all(), k
        scale = np.abs(r).max()
        assert np.abs(g - r).max() <= GRAD_RTOL * scale, (k, np.abs(g - r).max(), scale)


# Each objective as (JAX callable -> (loss, grads), port callable -> (loss
# scalar, its surrogate to differentiate)) on (params, scene, settings, frame,
# target, pixel ids, ids a, ids b).
def _jax_objective(name):
    if name == "pixel":
        fn = jax.value_and_grad(
            lambda p, s, st, f, t, pix, a, b: jinv.pixel_loss(p, s, st, f, t, pix, a))
        return jax.jit(fn, static_argnums=2)
    fn = jax.value_and_grad(jinv._OBJECTIVES[name], has_aux=True)

    def value_and_grad(*args):
        (_, loss), grads = fn(*args)
        return loss, grads

    return jax.jit(value_and_grad, static_argnums=2)


_JAX_OBJECTIVES = {}


def _port_objective(name, *args):
    if name == "pixel":
        loss = tinv.pixel_loss(*args[:-1])
        return loss, loss
    surrogate, loss = tinv._OBJECTIVES[name](*args)
    return loss, surrogate


def _objective_case(name, tied):
    """(port loss, port grads, JAX loss, JAX grads) of objective ``name`` at
    one paired step on the glossy box."""
    jscene, scene, camera = _scenes(tied=tied)
    jst, st = JaxSettings(**SIZE), RenderSettings(**SIZE)
    jframe, frame = _frames(camera, st)
    g = np.random.default_rng(5)
    target = g.uniform(0.0, 0.6, (N_PIX, 3)).astype(np.float32)
    if name == "display":
        target = g.uniform(0.0, 1.0, (N_PIX, 3)).astype(np.float32)
    pix = np.arange(N_PIX)
    (jpix, ja, jb), (tpix, ta, tb) = _ids(pix, np.zeros(N_PIX), np.ones(N_PIX))
    if name not in _JAX_OBJECTIVES:
        _JAX_OBJECTIVES[name] = _jax_objective(name)
    jloss, jgrads = _JAX_OBJECTIVES[name](
        jinv.material_params(jscene), jscene, jst, jframe, jnp.asarray(target), jpix, ja, jb)
    params = _leaf_params(scene)
    loss, surrogate = _port_objective(name, params, scene, st, frame,
                                      torch.as_tensor(target), tpix, ta, tb)
    surrogate.backward()
    return (float(loss.detach()), {k: v.grad for k, v in params.items()}, float(jloss),
            jgrads)


@pytest.mark.parametrize("tied", [False, True], ids=["glossy", "tied"])
@pytest.mark.parametrize("name", ["radiance", "display", "pixel"])
def test_objectives_match_jax_grad(name, tied):
    """The paired objectives (radiance and display space) and pixel_loss:
    loss and the gradients of all four fields against jax.grad; "tied" puts
    radiance exactly on the per-sample clamp's bound with a live gradient."""
    loss, grads, jloss, jgrads = _objective_case(name, tied)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert all(float(jnp.abs(jgrads[k]).max()) > 0 for k in tinv.PARAM_FIELDS)
    _assert_grads(grads, jgrads)
    assert intersect_small.launches == {"closest": 0, "occluded": 0}


def test_radiance_tie_splits_the_gradient_as_jax(monkeypatch):
    """At radiance exactly 0 the per-sample clamp passes half the gradient,
    as jnp.maximum does: the port matches jax.grad of pixel_loss on the
    tied scene, where torch.clamp (the full gradient) does not."""
    loss, grads, _, jgrads = _objective_case("pixel", tied=True)
    _assert_grads(grads, jgrads)
    monkeypatch.setattr(tinv, "maximum", lambda x, b: torch.clamp(x, min=b))
    _, clamped, _, _ = _objective_case("pixel", tied=True)
    r, c = np.asarray(jgrads["mat_Kd"])[RED, 1:], clamped["mat_Kd"][RED, 1:].numpy()
    assert np.abs(c - r).max() > 0.5 * np.abs(r).max(), (c, r)


def _exactly_one_row():
    """A radiance row whose first channel the reference tonemap maps to
    exactly 1.0 before its clip, in both packages (searched by ULPs around
    the fixed point x = 1 / scale(x))."""
    rest = np.float32([0.3, 0.2])

    def pre(x, jax_side):
        row = np.concatenate([[x], rest]).astype(np.float32)[None]
        if jax_side:
            lum = jnp.mean(row, axis=-1, keepdims=True)
            return float((row * jnp.power(jnp.maximum(lum / (lum + 1.0), 1e-20), 0.01))[0, 0])
        t = torch.as_tensor(row)
        lum = t.mean(-1, keepdim=True)
        return float((t * torch.pow(torch.clamp(lum / (lum + 1.0), min=1e-20), 0.01))[0, 0])

    x = np.float32(1.0)
    for _ in range(20):
        x = np.float32(x / pre(x, False))
    for k in range(-100, 100):
        xx = np.array([x]).view(np.int32) + k
        xx = xx.view(np.float32)[0]
        if pre(xx, False) == 1.0 and pre(xx, True) == 1.0:
            return np.concatenate([[xx], rest]).astype(np.float32)
    raise AssertionError("no row with a tonemapped value of exactly 1.0")


def test_display_ties_split_the_gradient_as_jax():
    """The display weight (the gradient of the display loss at a detached
    wave) at tonemapped values exactly 0 (black rows) and exactly 1 equals
    jax.grad's, which passes half the gradient there; torch.clamp's tonemap
    would pass all of it."""
    g = np.random.default_rng(9)
    rows = g.uniform(0.0, 1.5, (64, 3)).astype(np.float32)
    rows[::5] = 0.0
    rows[3] = _exactly_one_row()
    target = g.uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    w = tinv._display_weight(torch.as_tensor(rows), torch.as_tensor(target)).numpy()
    ref = np.asarray(jax.grad(
        lambda r: jnp.mean((jax_tonemap(r) - jnp.asarray(target)) ** 2))(jnp.asarray(rows)))
    np.testing.assert_allclose(w, ref, rtol=1e-5, atol=1e-9)
    assert (ref[::5] != 0).all() and ref[3, 0] != 0

    x = torch.as_tensor(rows).requires_grad_(True)
    lum = x.mean(-1, keepdim=True)
    out = torch.clamp(x * torch.pow(torch.clamp(lum / (lum + 1.0), min=1e-20), 0.01), 0.0, 1.0)
    (c,) = torch.autograd.grad(torch.mean((out - torch.as_tensor(target)) ** 2), x)
    # Black rows: twice the gradient. The row at 1: its other channels reach
    # the first through the luminance untied, so only a share doubles.
    np.testing.assert_allclose(c.numpy()[::5], 2 * ref[::5], rtol=1e-5)
    assert abs(c[3, 0].item() - ref[3, 0]) > 1e-3 * abs(ref[3, 0])


def test_ns_grad_matches_jax_and_finite_difference():
    """Twin of test_ns_grad_matches_finite_difference: d mean radiance / d Ns
    of the glossy box by path replay, against jax.grad and central finite
    differences."""
    jscene, scene, camera = _scenes()
    kw = dict(width=8, height=8, max_depth=3, scheduler="scan", compat_count_light_pdf=False)
    jst, st = JaxSettings(**kw), RenderSettings(**kw)
    n = 128
    jframe, frame = _frames(camera, st)
    (jpix, jsmp), (pix, smp) = _ids(np.arange(n), np.zeros(n))
    jo, jd = jax_rays(jframe, 8, 8, jpix % 64, jrng.pixel_jitter(jst, jpix, jsmp))
    o, d = generate_rays(frame, 8, 8, pix % 64, rng.pixel_jitter(st, pix, smp))

    def loss(ns):
        s = dataclasses.replace(scene, mat_Ns=ns)
        return torch.mean(integrator.radiance_batch(s, st, o, d, pix, smp))

    ref = jax.grad(lambda ns: jnp.mean(jax_radiance(
        jscene.replace(mat_Ns=ns), jst, jo, jd, jpix, jsmp)))(jscene.mat_Ns)
    ns0 = scene.mat_Ns.clone().requires_grad_(True)
    loss(ns0).backward()
    got = ns0.grad.numpy()
    assert got[GLOSSY] != 0.0, "glossy Ns receives no gradient"
    _assert_grads({"mat_Ns": ns0.grad}, {"mat_Ns": ref})
    eps = 5e-2  # Ns ~ 40; the loss is smooth in Ns with compat off
    e = torch.zeros_like(scene.mat_Ns)
    e[GLOSSY] = eps
    with torch.no_grad():
        fd = float((loss(scene.mat_Ns + e) - loss(scene.mat_Ns - e)) / (2 * eps))
    assert abs(got[GLOSSY] - fd) < 1e-4 + 0.05 * abs(fd), (got[GLOSSY], fd)


def test_replay_runs_each_bounce_under_checkpoint(monkeypatch):
    """With a material requiring grad each bounce runs under
    torch.utils.checkpoint, and the replayed gradient equals the one kept
    without replay bit for bit; a render without grad takes no checkpoint."""
    _, scene, camera = _scenes()
    st = RenderSettings(**SIZE)
    frame = ray_frame_tensors(camera, st.width, st.height, "cpu")
    pix, smp = torch.arange(N_PIX), torch.zeros(N_PIX, dtype=torch.int64)
    calls = []
    real = integrator.checkpoint

    def counted(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    def grads():
        params = _leaf_params(scene)
        tinv.pixel_loss(params, scene, st, frame, torch.full((N_PIX, 3), 0.2), pix,
                        smp).backward()
        return {k: v.grad for k, v in params.items()}

    monkeypatch.setattr(integrator, "checkpoint", counted)
    replayed = grads()
    assert len(calls) == SIZE["max_depth"]
    assert all(kw == {"use_reentrant": False, "preserve_rng_state": False} for kw in calls)
    calls.clear()
    render(scene, camera, dataclasses.replace(st, samples_per_pixel=1))
    with torch.no_grad():
        tinv.pixel_loss(_leaf_params(scene), scene, st, frame, torch.zeros((N_PIX, 3)),
                        pix, smp)
    assert calls == []
    monkeypatch.setattr(integrator, "checkpoint", lambda fn, *a, **kw: fn(*a))
    kept = grads()
    for k in replayed:
        assert torch.equal(replayed[k], kept[k]), k


@pytest.mark.parametrize("steps", [1, 3, 20, 120])
def test_cosine_schedule_equals_optax(steps):
    """The default schedule's learning rate at every step (and past the
    horizon) equals optax.cosine_decay_schedule's within its float32
    rounding."""
    import optax

    ref = optax.cosine_decay_schedule(5e-2, steps)
    ours = tinv.cosine_decay_schedule(5e-2, steps)
    for t in range(steps + 3):
        # optax computes in float32: its rounding of the peak value.
        np.testing.assert_allclose(ours(t), float(ref(t)), rtol=1e-6, atol=1.2e-7 * 5e-2)
    assert ours(0) == 5e-2


def _problem(glossy, size, spp, **kw):
    """(JAX scene, port scene, camera, port settings, target) with the
    target the port's render of the true scene."""
    jscene, scene, camera = _scenes(glossy=glossy)
    st = RenderSettings(**{**SIZE, **size, **kw}, samples_per_pixel=spp)
    with torch.no_grad():
        target = render(scene, camera, st).numpy()
    return jscene, scene, camera, st, target


def test_train_step_trajectory_matches_optax():
    """Three steps of the default recovery (Adam, cosine decay, clip
    projection) on all four fields of the perturbed glossy box, corrected
    estimator: params and losses against the JAX package's optax run."""
    jscene, scene, camera, st, target = _problem(
        True, dict(max_depth=3), 2, compat_count_light_pdf=False)
    jst = JaxSettings(**dataclasses.asdict(st))
    kd = np.asarray(scene.mat_Kd) * 0.5
    ref, jlosses = jinv.recover_materials(
        jscene.replace(mat_Kd=jnp.asarray(kd)), camera, jst, jnp.asarray(target), steps=3,
        learning_rate=5e-2)
    got, losses = tinv.recover_materials(
        dataclasses.replace(scene, mat_Kd=torch.as_tensor(kd)), camera, st, target, steps=3,
        learning_rate=5e-2)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for k in tinv.PARAM_FIELDS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert not np.array_equal(got["mat_Kd"].numpy(), kd)


def test_clip_projection():
    """After an update the fields are clipped as the JAX step clips them;
    a field without a range is left alone."""
    g = np.random.default_rng(2)
    raw = {"mat_Kd": g.uniform(-0.5, 1.5, (5, 3)), "mat_Ks": g.uniform(-0.5, 1.5, (5, 3)),
           "mat_Ke": g.uniform(-3.0, 20.0, (5, 3)), "mat_Ns": g.uniform(-10.0, 700.0, 5),
           "mat_Ka": g.uniform(-1.0, 2.0, (5, 3))}
    params = {k: torch.as_tensor(v, dtype=torch.float32).requires_grad_(True)
              for k, v in raw.items()}
    tinv.project_params(params)
    want = {"mat_Kd": (0.0, 1.0), "mat_Ks": (0.0, 1.0), "mat_Ke": (0.0, None),
            "mat_Ns": (1.0, 499.0)}
    for k, v in raw.items():
        v = v.astype(np.float32)
        ref = np.asarray(jnp.clip(v, *want[k])) if k in want else v
        np.testing.assert_array_equal(params[k].detach().numpy(), ref, err_msg=k)
        assert params[k].requires_grad


@pytest.fixture(scope="module")
def albedo_problem():
    """The twin of test_inverse.py's problem: true scene, camera, settings
    (24x24, depth 4) and the target at spp 16."""
    _, scene, camera, st, target = _problem(False, dict(width=24, height=24), 16)
    return scene, camera, st, target


def test_recover_albedo_converges(albedo_problem):
    """Twin of test_recover_albedo_converges, 60 steps instead of 100."""
    scene, camera, st, target = albedo_problem
    pert = dataclasses.replace(scene, mat_Kd=scene.mat_Kd * 0.5)
    params, losses = tinv.recover_materials(pert, camera, st, target, steps=60,
                                            learning_rate=0.05, fields=("mat_Kd",))
    err = (params["mat_Kd"] - scene.mat_Kd).abs().amax(dim=1).numpy()
    assert (err[:3] < 0.08).all(), f"per-material Kd error {err}"
    assert losses[-1] < losses[0]


def test_recover_checkpoint_resume_identical(albedo_problem, tmp_path):
    """Twin of test_recover_checkpoint_resume_identical: stop after 10 of 20
    steps, resume from the saved params and Adam state, and land bit for bit
    on the straight run."""
    scene, camera, st, target = albedo_problem
    pert = dataclasses.replace(scene, mat_Kd=scene.mat_Kd * 0.5)
    kw = dict(steps=20, learning_rate=0.05)
    straight, straight_losses = tinv.recover_materials(pert, camera, st, target, **kw)
    ckpt = str(tmp_path / "opt.npz")
    _, first = tinv.recover_materials(pert, camera, st, target, checkpoint_path=ckpt,
                                      checkpoint_every=5, stop_after=10, **kw)
    resumed, losses = tinv.recover_materials(pert, camera, st, target, checkpoint_path=ckpt,
                                             checkpoint_every=5, **kw)
    assert len(first) == 10 and len(losses) == 10  # only the remaining steps ran
    assert first + losses == straight_losses
    for k in straight:
        assert torch.equal(straight[k], resumed[k]), k


def test_save_load_pytree_round_trip_and_mismatch(tmp_path):
    g = np.random.default_rng(1)
    params = {"mat_Kd": torch.as_tensor(g.random((5, 3)), dtype=torch.float32)}
    opt = torch.optim.Adam([params["mat_Kd"].clone().requires_grad_()], lr=0.1)
    opt.param_groups[0]["params"][0].grad = torch.ones(5, 3)
    opt.step()
    tree = {"params": params, "opt": opt.state_dict()["state"], "step": 7,
            "extra": (np.arange(4, dtype=np.int32), [1.5, True])}
    path = str(tmp_path / "state.npz")
    save_pytree(path, tree)
    back = load_pytree(path, tree)
    assert back["step"] == 7 and isinstance(back["step"], int)
    assert torch.equal(back["params"]["mat_Kd"], params["mat_Kd"])
    for name, v in tree["opt"][0].items():
        assert torch.equal(back["opt"][0][name], v) and back["opt"][0][name].dtype == v.dtype
    np.testing.assert_array_equal(back["extra"][0], tree["extra"][0])
    assert back["extra"][1] == [1.5, True]
    for like in ({**tree, "params": {"mat_Ke": params["mat_Kd"]}}, {**tree, "step": (7,)},
                 {k: v for k, v in tree.items() if k != "extra"}):
        with pytest.raises(ValueError, match="structure mismatch"):
            load_pytree(path, like)


def test_recover_from_ground_truth(tmp_path):
    """Configuration 5's entry point on a PNG the test writes: the Cornell
    files, a 32^2 spp 16 render of the true scene tonemapped into a PNG, then
    an albedo fit at 16^2 from Kd x 0.5; the fit's display MSE (an spp 16
    evaluation render) is below half the perturbed start's, as in
    tests/test_inverse.py."""
    from pathtracer_tpu_torch.models.scene import load_scene
    from pathtracer_tpu_torch.ops.tonemap import tonemap_reference
    from pathtracer_tpu_torch.utils.image import read_png, write_png

    ini = procedural.write_cornell_box_files(str(tmp_path))
    scene, camera, st, _ = load_scene(ini, device="cpu", width=32, height=32,
                                      samples_per_pixel=16, max_depth=4, scheduler="scan")
    png = str(tmp_path / "target.png")
    write_png(png, tonemap_reference(render(scene, camera, st)).numpy())
    true, pert, params, losses = tinv.recover_from_ground_truth(
        ini, png, fit_size=16, steps=40, samples_per_pixel=4, max_depth=4, device="cpu")
    assert len(losses) == 40 and true.device.type == "cpu"
    torch.testing.assert_close(pert.mat_Kd, true.mat_Kd * 0.5)

    ev = dataclasses.replace(st, width=16, height=16, samples_per_pixel=16)
    gt = tinv.downsample_display(read_png(png), 2)

    def display_mse(s):
        return float(np.mean((tonemap_reference(render(s, camera, ev)).numpy() - gt) ** 2))

    mse_pert = display_mse(pert)
    mse_fit = display_mse(dataclasses.replace(pert, **params))
    assert mse_fit < 0.5 * mse_pert, (mse_pert, mse_fit)
