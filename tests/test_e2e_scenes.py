"""End-to-end coverage of the remaining reference scene families at
reduced scale (100 angles, 100x20 DMD, same 100x100x50 film as the
reference configs; quality bars set for the reduced workload):

  * occlusions (mesh blocker inside a square vial,
    tests/files/box_hole_occlusion.json)
  * custom mesh cuvette + telecentric projector
    (box_hole_custom_cuvette.json)
  * filter_radon pixel culling
  * sparsity loss + filter_corner culling
    (box_hole_square_sparsity_loss.json)

All exercise the wavefront MC engine (mesh surfaces / culling are not
ballistic-eligible paths).
"""
import numpy as np
import pytest

from tests.test_optimization import analytic_phantom


def base_config(mesh_path, out, vial, **extra):
    cfg = {
        "vial": vial,
        "projector": {"type": "collimated", "n_patterns": 100,
                      "resx": 100, "resy": 20, "pixel_size": 0.05,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5,
                   "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": 100, "resy": 100,
                            "resz": 50}},
        "target": {"filename": mesh_path, "size": 4.0},
        "loss": {"type": "threshold", "tl": 0.85, "tu": 0.95},
        "progressive": True,
        "n_steps": 20,
        "output": out,
    }
    cfg.update(extra)
    return cfg


@pytest.fixture
def meshes(tmp_path):
    from drtvam_tpu.ops.mesh import (make_box_with_hole, make_box,
                                     make_box_tube, save_ply)
    paths = {}
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0), segments=99),
             str(tmp_path / "box_hole.ply"))
    paths["target"] = str(tmp_path / "box_hole.ply")
    # occlusion box, world half-extents (1.0, 0.5, 0.25) at the origin
    # (matches the reference's occlusion.ply bbox)
    save_ply(make_box((1.0, 0.5, 0.25)), str(tmp_path / "occ.ply"))
    paths["occ"] = str(tmp_path / "occ.ply")
    # cuvette tubes matching the reference fixtures' dimensions
    save_ply(make_box_tube(3.765, 3.71, -5.0, 5.0),
             str(tmp_path / "cuv_outer.ply"))
    save_ply(make_box_tube(2.5, 2.41, -5.0, 5.0),
             str(tmp_path / "cuv_inner.ply"))
    paths["cuv_outer"] = str(tmp_path / "cuv_outer.ply")
    paths["cuv_inner"] = str(tmp_path / "cuv_inner.ply")
    return paths


def run(cfg):
    from drtvam_tpu.opt.optimize import optimize
    import os
    os.makedirs(cfg["output"], exist_ok=True)
    return optimize(cfg)


def agreement(cfg, vol, phantom):
    thr = (cfg["loss"]["tl"] + cfg["loss"]["tu"]) / 2
    return np.mean(np.isclose(phantom, vol[:, :, :, 0] > thr)) * 100


# ---- non-slow smoke gates: few-iteration runs of the
# mesh/occlusion/culling families so the default suite exercises
# their scene assembly, march paths, and culling renders end to end.
# Bars are functional (calibrated loose for the tiny workload); the
# slow tests above carry the quality bars.


def smoke_config(mesh_path, out, vial, **extra):
    cfg = base_config(mesh_path, out, vial, **extra)
    cfg["projector"].update(n_patterns=48, resx=48, resy=10,
                            pixel_size=50e-3 * 100 / 48)
    cfg["sensor"]["film"] = {"type": "vfilm", "resx": 48, "resy": 48,
                             "resz": 24}
    cfg["n_steps"] = 6
    return cfg


def test_smoke_occlusion(meshes, tmp_path):
    cfg = smoke_config(
        meshes["target"], str(tmp_path / "out"),
        {"type": "square", "w_int": 7.191, "w_ext": 7.6, "ior": 1.3,
         "medium": {"ior": 1.15, "phase": {"type": "rayleigh"},
                    "extinction": 0.06, "albedo": 0.0},
         "occlusions": [{"filename": meshes["occ"]}]},
        loss={"type": "threshold", "tl": 0.9, "tu": 0.97})
    vol = run(cfg)
    film = (48, 48, 24)
    ref = analytic_phantom(film)
    occ = np.zeros_like(ref)
    # occlusion box (1.0, 0.5, 0.25) half-extents in the 5x5x1.25 world
    occ[7:17, 19:29, 14:34] = 1
    ref = np.clip(ref - occ, 0, 1)
    pct = agreement(cfg, vol, ref)
    assert pct > 75.0, f"agreement {pct:.2f}%"
    # the shadowed occlusion volume must stay (mostly) unpolymerized
    thr = (cfg["loss"]["tl"] + cfg["loss"]["tu"]) / 2
    pred = vol[:, :, :, 0] > thr
    assert pred[occ > 0].mean() < 0.5


def test_smoke_custom_cuvette_telecentric(meshes, tmp_path):
    cfg = smoke_config(
        meshes["target"], str(tmp_path / "out"),
        {"type": "custom",
         "filename_vial_outer": meshes["cuv_outer"],
         "filename_vial_inner": meshes["cuv_inner"],
         "ior": 1.4702,
         "medium": {"ior": 1.33, "phase": {"type": "rayleigh"},
                    "extinction": 0.06, "albedo": 0.0}},
        loss={"type": "threshold", "tl": 0.9, "tu": 0.97})
    cfg["projector"].update(type="telecentric", focus_distance=20,
                            aperture_radius=0.01)
    vol = run(cfg)
    pct = agreement(cfg, vol, analytic_phantom((48, 48, 24)))
    assert pct > 80.0, f"agreement {pct:.2f}%"


def test_smoke_sparsity_filter_corner(meshes, tmp_path):
    cfg = smoke_config(
        meshes["target"], str(tmp_path / "out"),
        {"type": "square", "w_int": 10.191, "w_ext": 12.408,
         "ior": 1.54,
         "medium": {"ior": 1.347, "phase": {"type": "rayleigh"},
                    "extinction": 0.03, "albedo": 0.0}},
        loss={"type": "threshold", "tl": 0.80, "tu": 0.95,
              "weight_sparsity": 0.01, "M": 4},
        filter_corner={"dist": 6.204, "radius": 0.2})
    vol = run(cfg)
    pct = agreement(cfg, vol, analytic_phantom((48, 48, 24)))
    assert pct > 70.0, f"agreement {pct:.2f}%"


@pytest.mark.slow
def test_e2e_occlusion(meshes, tmp_path):
    """Reference test_square_hole_occlusion_optimization semantics:
    the occlusion volume is excluded from the expected print."""
    cfg = base_config(
        meshes["target"], str(tmp_path / "out"),
        {"type": "square", "w_int": 7.191, "w_ext": 7.6, "ior": 1.3,
         "medium": {"ior": 1.15, "phase": {"type": "rayleigh"},
                    "extinction": 0.06, "albedo": 0.0},
         "occlusions": [{"filename": meshes["occ"]}]},
        loss={"type": "threshold", "tl": 0.9, "tu": 0.97})
    vol = run(cfg)
    ref = analytic_phantom()
    occ = np.zeros_like(ref)
    occ[15:35, 40:60, 30:70] = 1
    ref = np.clip(ref - occ, 0, 1)
    pct = agreement(cfg, vol, ref)
    assert pct > 94.0, f"agreement {pct:.2f}%"


@pytest.mark.slow
def test_e2e_custom_cuvette_telecentric(meshes, tmp_path):
    cfg = base_config(
        meshes["target"], str(tmp_path / "out"),
        {"type": "custom",
         "filename_vial_outer": meshes["cuv_outer"],
         "filename_vial_inner": meshes["cuv_inner"],
         "ior": 1.4702,
         "medium": {"ior": 1.33, "phase": {"type": "rayleigh"},
                    "extinction": 0.06, "albedo": 0.0}},
        loss={"type": "threshold", "tl": 0.9, "tu": 0.97})
    cfg["projector"] = {"type": "telecentric", "n_patterns": 100,
                        "resx": 100, "resy": 20, "pixel_size": 0.05,
                        "motion": "circular", "distance": 20,
                        "focus_distance": 20, "aperture_radius": 0.01}
    vol = run(cfg)
    pct = agreement(cfg, vol, analytic_phantom())
    assert pct > 96.0, f"agreement {pct:.2f}%"


@pytest.mark.slow
def test_e2e_filter_radon(meshes, tmp_path):
    cfg = base_config(
        meshes["target"], str(tmp_path / "out"),
        {"type": "square", "w_int": 7.0, "w_ext": 8.0, "ior": 1.24,
         "medium": {"ior": 1.347, "phase": {"type": "rayleigh"},
                    "extinction": 0.07, "albedo": 0.0}},
        filter_radon=True)
    vol = run(cfg)
    pct = agreement(cfg, vol, analytic_phantom())
    assert pct > 97.0, f"agreement {pct:.2f}%"
    # culling must have removed a substantial share of DMD pixels
    patterns = np.load(str(tmp_path / "out" / "patterns.npz"))["patterns"]
    lit_frac = np.count_nonzero(patterns) / patterns.size
    assert lit_frac < 0.95


@pytest.mark.slow
def test_e2e_sparsity_filter_corner(meshes, tmp_path):
    cfg = base_config(
        meshes["target"], str(tmp_path / "out"),
        {"type": "square", "w_int": 10.191, "w_ext": 12.408,
         "ior": 1.54,
         "medium": {"ior": 1.347, "phase": {"type": "rayleigh"},
                    "extinction": 0.03, "albedo": 0.0}},
        loss={"type": "threshold", "tl": 0.80, "tu": 0.95,
              "weight_sparsity": 0.1, "M": 4},
        filter_corner={"dist": 6.204, "radius": 0.2},
        spp=10, spp_grad=10, spp_ref=10)
    vol = run(cfg)
    # heavy sparsity penalty at reduced angle count trades print
    # fidelity for pattern sparsity; the reference never asserts quality
    # for this config (it is an unused fixture there) -- this is a
    # functional gate.
    pct = agreement(cfg, vol, analytic_phantom())
    assert pct > 85.0, f"agreement {pct:.2f}%"
