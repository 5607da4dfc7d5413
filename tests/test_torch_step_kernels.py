"""The no-grad wavefront step's kernels (`ops/step.py`, `csrc/step.cu`)
against their plain twin, the torch chain of `integrator.wavefront_step`.
No JAX: the card runs the requires_cuda tests with `python -m pytest
tests/test_torch_step_kernels.py --noconftest -o addopts="" -m
requires_cuda`.

(a) The dispatch rule (`integrator.fused_step`): the kernels only on a
    CUDA device, with grad mode off, on a baked, untextured, hair-free
    scene; the chain on the CPU, under grad, and on hair, textured and
    instanced scenes. No CUDA tensor is made.
(b) On the CPU the step takes the chain: on packed rows, and on wider
    rows (the loop's), the chain's PathState packed, to the bit.
(c) The kernels' per-lane code (`csrc/step.cuh`) compiled for the host
    (`tests/step_host.cpp`) against the chain on the CPU, every step of
    six depths of the SSS cornellbox: every column within rtol 1e-4 (the
    host's libm and the CPU's sums round apart from torch's by ulps).
(d) On the card, every `wavefront_step` of the first 8 sub-iterations of
    a 256x256 render (65536 lanes) of the cornellbox and of bench.py's
    XL scene (dense_v5s / dense_v5l), through the volume window and
    without it, is the chain's to the bit on all 39 packed columns: full
    steps, windowed and unwindowed substeps, resolve_pending on and off,
    states with volume, dead and pending-NEE lanes.
(e) On the card, a 64x64x1 graphed gradient pass, whose forward takes the
    kernels and whose per-depth backward the chain, gives the image and
    loss of a forward forced onto the chain, and its gradients within
    1e-4 of the largest entry (the backward's atomics, ROADMAP C12); the
    `step` counters count the forward's steps as fused and only the
    backward's recomputes as chain.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.ops import step as step_kernels
from pbrlab_tpu_torch.ops.intersect import (sparse_backend, trace_scene,
                                            trace_scene_dual)
from pbrlab_tpu_torch.render import graphs
from pbrlab_tpu_torch.render import integrator as tint
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.scene import build_fat_tables, scene_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

SEED = 2**31 + 12345  # past 32 signed bits, as the benchmark's seeds
CSRC = Path(__file__).resolve().parents[1] / "pbrlab_tpu_torch" / "csrc"
GRAD_BAND = 1e-4  # of the largest entry (chip_smoke.py GRAD_BAND)
# columns the card may give within 2 ulp of the chain (a libm call the
# kernel cannot match); none: the kernels match every column
ULP_COLUMNS = {}
EXACT = (14, 15, 17)  # rng, alive, mode


def _instanced_scene():
    """A floor, a light and four shared instances of a sphere."""
    from pbrlab_tpu_torch.scene import demo
    from pbrlab_tpu_torch.scene.instanced import build_instanced
    from pbrlab_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    white = b.materials.add_principled("floor", base_color=(0.7,) * 3)
    b.add_instance([demo.quad_mesh([-3, 0, -3], [-3, 0, 3], [3, 0, 3],
                                   [3, 0, -3], white, "floor")])
    lid = b.add_area_light_param((12.0,) * 3)
    b.add_instance([demo.quad_mesh([-1, 4, -1], [1, 4, -1], [1, 4, 1],
                                   [-1, 4, 1], white, "light")],
                   light_ids=[np.full((2,), lid, np.int32)])
    ts = np.stack([np.eye(4, dtype=np.float32)] * 4)
    ts[:, 0, 3] = [-1.5, -0.5, 0.5, 1.5]
    ts[:, 1, 3] = 0.5
    b.add_shared_instances([demo.icosphere(1, 0.4, material_id=white,
                                           name="ball")], ts)
    return build_instanced(b)


def _textured_scene():
    """A checker-textured floor under a light."""
    from pbrlab_tpu_torch.scene import demo
    from pbrlab_tpu_torch.scene.scene import SceneBuilder, commit

    b = SceneBuilder()
    tex = np.zeros((2, 2, 3), np.float32)
    tex[0, 0] = tex[1, 1] = (1.0, 0.0, 0.0)
    floor = b.materials.add_principled(
        "floor", specular=0.0, base_color_tex_id=b.add_texture(tex))
    light = b.materials.add_principled("light", base_color=(0, 0, 0))
    b.add_instance([demo.quad_mesh([-1, 0, -1], [-1, 0, 1], [1, 0, 1],
                                   [1, 0, -1], floor, "floor")])
    lid = b.add_area_light_param((3.0,) * 3)
    b.add_instance([demo.quad_mesh([-0.4, 1.5, -0.4], [0.4, 1.5, -0.4],
                                   [0.4, 1.5, 0.4], [-0.4, 1.5, 0.4], light,
                                   "light")],
                   light_ids=[np.full((2,), lid, np.int32)])
    return commit(b.build())


@pytest.fixture(scope="module")
def rule_scenes():
    """Each kind of scene the rule tells apart, committed for the CPU."""
    out = {}
    for name, make in (
            ("baked", lambda: build_demo_scene(subdiv=1)[0]),
            ("hair", lambda: build_demo_scene(subdiv=1, with_hair=True)[0]),
            ("textured", _textured_scene), ("instanced", _instanced_scene)):
        out[name] = build_fat_tables(scene_from_numpy(make(), "cpu"))
    return out


@pytest.mark.parametrize("name, device, grad, fused", [
    ("baked", "cuda", False, True),
    ("baked", "cuda", True, False),
    ("baked", "cpu", False, False),
    ("hair", "cuda", False, False),
    ("textured", "cuda", False, False),
    ("instanced", "cuda", False, False),
])
def test_dispatch_rule(rule_scenes, name, device, grad, fused):
    scene = rule_scenes[name]
    assert ("iface_fat" in scene) == (name == "instanced")
    assert ("texture_quad" in scene) == (name == "textured")
    with torch.set_grad_enabled(grad):
        assert tint.fused_step(scene, torch.device(device)) is fused


@pytest.fixture(scope="module")
def sss_scene():
    return build_fat_tables(scene_from_numpy(build_demo_scene(subdiv=1)[0],
                                             "cpu"))


@pytest.fixture(scope="module")
def sss_states(sss_scene):
    """States of 32x32 lanes after 0-2 depths (each a full step and three
    substeps) of the chain: entry states of a full step, a first and a
    later substep."""
    st = tint.init_state(sss_scene, 32, 32, 0, SEED)
    out = {}
    with torch.no_grad():
        for depth in range(3):
            out[("full", depth)] = st
            st = tint._wavefront_step_chain(sss_scene, st)
            for i in range(3):
                out[("first" if i == 0 else "later", depth)] = st
                st = tint._wavefront_step_chain(
                    sss_scene, st, freeze_surface=True,
                    resolve_pending=i == 0)
    return out


@pytest.mark.parametrize("kind", ["full", "first", "later"])
def test_cpu_steps_take_the_chain(sss_scene, sss_states, kind,
                                  monkeypatch):
    def no_kernels(*a, **k):
        raise AssertionError("the kernels ran on the CPU")

    monkeypatch.setattr(tint, "_fused_step", no_kernels)
    kw = {} if kind == "full" else dict(freeze_surface=True,
                                        resolve_pending=kind == "first")
    st = sss_states[(kind, 2)]
    assert bool((st.alive & (st.mode == tint.MODE_VOLUME)).any())
    with torch.no_grad():
        want = tint.pack_state(tint._wavefront_step_chain(sss_scene, st,
                                                          **kw))
        got_rows = tint.wavefront_step(sss_scene, tint.pack_state(st), **kw)
        wide = torch.cat([tint.pack_state(st), torch.ones((st.org.shape[0],
                                                           7))], dim=1)
        got_wide = tint.wavefront_step(sss_scene, wide, **kw)
    for got in (got_rows, got_wide):
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.fixture(scope="module")
def host_step(tmp_path_factory):
    """tests/step_host.cpp (csrc/step.cuh for the host) as a library."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    out = tmp_path_factory.mktemp("step_host") / "step_host.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-fPIC",
                    "-shared", f"-I{CSRC}",
                    str(Path(__file__).with_name("step_host.cpp")), "-o",
                    str(out)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _host_fused(lib, scene, rows, freeze, resolve_pending):
    """`integrator._fused_step` with the host's build of the per-lane
    code in place of the kernels."""
    def ptr(x):
        return None if x is None else ctypes.c_void_p(x.data_ptr())

    n = rows.shape[0]
    backend = sparse_backend(scene) if freeze else None
    resolving = not freeze or resolve_pending
    rays = [torch.empty(s) for s in ((n, 3), (n, 3), (n,), (n,))]
    shadow = [torch.empty(s) for s in ((n, 3), (n,), (n,))]
    lib.host_pre(ptr(rows), 39, n, int(freeze), int(resolving),
                 *map(ptr, rays), *map(ptr, shadow))
    occ = None
    if resolving:
        hit, occ = trace_scene_dual(scene, *rays, *shadow, backend=backend)
        occ = occ.to(torch.uint8)
    else:
        hit = trace_scene(scene, *rays, backend=backend)
    out = torch.empty((n, 39))
    face, mat = scene["face_fat"], scene["mat_fat"]
    light, cdf = scene["light_fat"], scene["light_cdf"]
    lib.host_shade(ptr(rows), 39, n, int(freeze), int(resolving),
                   *(ptr(hit[k].contiguous()) for k in ("t", "u", "v")),
                   ptr(hit["prim"].to(torch.int32).contiguous()), ptr(occ),
                   ptr(face), face.shape[0], ptr(mat), mat.shape[1],
                   mat.shape[0], ptr(light), ptr(cdf), cdf.shape[0],
                   ptr(out))
    return out


def test_step_code_on_the_host(host_step, sss_scene):
    st = tint.init_state(sss_scene, 32, 32, 0, SEED)
    kinds = set()
    with torch.no_grad():
        for depth in range(6):
            for i in range(4):
                freeze, rp = i > 0, i == 1
                rows = tint.pack_state(st)
                want = tint.pack_state(tint._wavefront_step_chain(
                    sss_scene, st, freeze_surface=freeze,
                    resolve_pending=rp))
                got = _host_fused(host_step, sss_scene, rows, freeze, rp)
                close = torch.isclose(got, want, rtol=1e-4, atol=1e-6)
                close[:, 14] = got[:, 14].view(torch.int32) == \
                    want[:, 14].view(torch.int32)
                assert close.all(), (depth, i, torch.nonzero(
                    ~close.all(0)).flatten().tolist())
                kinds.add((freeze, rp, bool((st.mode == 1).any())))
                st = tint.unpack_state(want)
    assert {(False, False, True), (True, True, True),
            (True, False, True)} <= kinds


# --- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only there)")
    return torch.device("cuda:0")


def _bits_diff(got, want):
    """{column: (lanes that differ, largest distance in ulp)}."""
    g = got.view(torch.int32).to(torch.int64)
    w = want.view(torch.int32).to(torch.int64)
    out = {}
    for c in range(got.shape[1]):
        ne = g[:, c] != w[:, c]
        if bool(ne.any()):
            out[c] = (int(ne.sum()), int((g[:, c] - w[:, c]).abs()[ne].max()))
    return out


class _Enough(Exception):
    pass


@pytest.mark.requires_cuda
@pytest.mark.parametrize("window", ["window", "full"])
@pytest.mark.parametrize("name, kw", [
    ("cornellbox", dict(subdiv=3)),
    ("xl", dict(subdiv=6, irregular=True)),
])
def test_fused_step_is_the_chain_on_the_card(name, kw, window, monkeypatch):
    dev = _cuda()
    scene = build_fat_tables(scene_from_numpy(build_demo_scene(**kw)[0],
                                              dev))
    step = tint.wavefront_step
    seen, diffs = [], []

    def checked(scene, state, *a, **k):
        got = step(scene, state, *a, **k)
        if not tint.fused_step(scene, state.device):
            return got
        rows = state[:, :39]
        want = tint.pack_state(tint._wavefront_step_chain(
            scene, tint.unpack_state(rows), *a, **k))
        diff = _bits_diff(got, want)
        kind = (k.get("freeze_surface", False),
                k.get("resolve_pending", False), k.get("windowed", False))
        seen.append((kind, int(((rows[:, 15] > 0.5)
                                & (rows[:, 17] > 0.5)).sum()),
                     int((rows[:, 15] <= 0.5).sum()),
                     int((rows[:, 38] >= 0.0).sum())))
        if diff:
            diffs.append((len(seen), kind, diff))
        if len(seen) >= 32:  # 8 sub-iterations of 1 + k_volume steps
            raise _Enough
        return got

    monkeypatch.setattr(tint, "wavefront_step", checked)
    with pytest.raises(_Enough):
        tint._wavefront(graphs.EagerRunner(), scene, 256, 256, 2, seed=SEED,
                        max_steps=12, k_volume=3,
                        vol_window=None if window == "window" else 1)
    kinds = {s[0] for s in seen}
    assert (False, False, False) in kinds
    substeps = ({(True, True, True), (True, False, True)} if window == "window"
                else {(True, True, False), (True, False, False)})
    assert substeps <= kinds, kinds
    assert any(s[1] for s in seen) and any(s[2] for s in seen) \
        and any(s[3] for s in seen)  # walkers, dead lanes, pending NEE
    for call, kind, diff in diffs:
        bad = {c: d for c, d in diff.items()
               if c in EXACT or c not in ULP_COLUMNS or d[1] > 2}
        assert not bad, f"call {call} {kind}: columns (lanes, ulp) {diff}"


def _grad_pass(scene_np, dev, size=64):
    scene = scene_from_numpy(scene_np, dev)
    mats = dict(scene["materials"])
    leaves = {k: mats[k].clone().requires_grad_()
              for k in ("base_color", "roughness", "subsurface_radius")}
    mats.update(leaves)
    emission = scene["face_emission"].clone().requires_grad_()
    scene = {**scene, "materials": mats, "face_emission": emission}
    before = dict(step_kernels.LAUNCHES)
    img = tint.render_lanes(scene, size, size, 0, SEED, max_steps=12,
                            k_volume=3, remat=True)
    fwd = {k: step_kernels.LAUNCHES[k] - before[k] for k in before}
    loss = (img * img).mean()
    grads = torch.autograd.grad(loss, [*leaves.values(), emission])
    torch.cuda.synchronize()
    counts = {k: step_kernels.LAUNCHES[k] - before[k] for k in before}
    return img, loss, grads, fwd, counts


@pytest.mark.requires_cuda
def test_graphed_grad_pass_with_fused_forward(monkeypatch):
    dev = _cuda()
    scene_np = build_demo_scene(subdiv=3)[0]
    img, loss, grads, fwd, counts = _grad_pass(scene_np, dev)
    with monkeypatch.context() as m:
        m.setattr(tint, "fused_step", lambda scene, device: False)
        img_c, loss_c, grads_c, fwd_c, counts_c = _grad_pass(scene_np, dev)
    assert torch.equal(img, img_c) and torch.equal(loss, loss_c)
    for g, want in zip(grads, grads_c):
        band = GRAD_BAND * float(want.abs().max())
        assert float((g - want).abs().max()) <= band
    # the forward's steps are all fused; the chain runs only in the
    # backward's recomputes, as many as the forward's steps
    assert fwd["chain"] == 0 and fwd["fused"] >= 12
    assert counts["chain"] == fwd["fused"] == counts["fused"] == fwd["pre"]
    assert fwd_c == {"pre": 0, "fused": 0, "chain": fwd["fused"]}
