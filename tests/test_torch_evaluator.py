"""Port vs JAX: the evaluation slice as a whole, on tests/test_evaluator.py's
small setup (a synthetic set of 16 scans, num_points 512, cap0 256), the
flax variables carried into the port by `load_flax_variables`.

The JAX GLEvaluator runs once (one jit per program); the port's evaluators
run on the CPU.  RANSAC's draws are JAX's, recomputed per pair with the
per-pair keys of `egonn_tpu/eval/evaluator.py` and handed to the port's
`ransac_6dof` through a wrapper."""
import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonn_tpu.config import TrainingParams
from egonn_tpu.data.synthetic import generate_synthetic_dataset
from egonn_tpu.eval.evaluator import GLEvaluator as JGLEvaluator
from egonn_tpu.models.factory import model_factory as j_model_factory
from egonn_tpu.ops.ransac import mutual_matches as j_mutual_matches
from egonn_tpu.sparse.pyramid import build_pyramid as j_build_pyramid
from egonn_tpu_torch import evaluate as t_evaluate_cli
from egonn_tpu_torch import evaluate_with_rotations as t_rotations_cli
from egonn_tpu_torch.eval import evaluator as t_evaluator
from egonn_tpu_torch.eval.evaluator import Evaluator, GLEvaluator
from egonn_tpu_torch.eval.rotations import RotationEvaluator
from egonn_tpu_torch.models.factory import create_egonn_model
from egonn_tpu_torch.ops.quantization import PolarQuantizer
from egonn_tpu_torch.sparse.calibrate import calibrate_capacities
from egonn_tpu_torch.train.state import TrainState, save_checkpoint
from egonn_tpu_torch.utils.weights import load_flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_POINTS, CAP0, N_K, N_HYP = 512, 256, (16,), 64
SMALL_CONFIG = ("[MODEL]\nmodel = egonn\ncoordinates = polar\nquantization_step = 1., 0.3, 0.2\n"
                f"\n[TPU]\nnum_points = {N_POINTS}\ncap0 = {CAP0}\n")


class _MP:
    model, cap0 = "egonn", CAP0
    quantizer = PolarQuantizer([1.0, 0.3, 0.2])


def _perturb_bn(variables, rng):
    """Random running statistics and affines for every BatchNorm (as
    tests/test_torch_model.py does): at its initial statistics the random
    model's local descriptors are almost equal, and their nearest-neighbour
    gaps fall to f32 rounding."""
    v = jax.tree_util.tree_map(np.array, flax.core.unfreeze(variables))

    def walk(params, stats):
        for name, sub in params.items():
            if set(sub) == {"scale", "bias"}:
                f = sub["scale"].shape[0]
                sub["scale"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.2, f).astype(np.float32)
                stats[name]["mean"] = rng.normal(0, 0.2, f).astype(np.float32)
                stats[name]["var"] = rng.uniform(0.5, 2.0, f).astype(np.float32)
            elif isinstance(sub, dict) and name in stats:
                walk(sub, stats[name])

    walk(v["params"], v["batch_stats"])
    return v


def _jax_draws(valid, key):
    """JAX's draws of one pair (`ops/ransac.py`'s split and choice calls)."""
    probs = jnp.asarray(valid).astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-9)
    keys = jax.random.split(key, N_HYP)
    return np.array(jax.vmap(lambda k: jax.random.choice(
        k, valid.shape[0], shape=(3,), replace=False, p=probs))(keys), dtype=np.int64)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval") / "synth")
    _, _, eval_p = generate_synthetic_dataset(root, n_scans=16, extent=60.0, scan_radius=40.0,
                                              max_points=4096, seed=0)
    params = TrainingParams(os.path.join(ROOT, "config/config_egonn.txt"),
                            os.path.join(ROOT, "model_configs/egonn.txt"),
                            require_dataset=False)
    built_j = j_model_factory(params.model_params, cap0=CAP0)
    q, spec = built_j.quantizer, built_j.pyramid_spec
    rng = np.random.default_rng(0)
    th, rad, z = rng.uniform(0, 2 * np.pi, (2, N_POINTS)), rng.uniform(2, 50, (2, N_POINTS)), \
        rng.uniform(-1, 8, (2, N_POINTS))
    c2 = jnp.asarray(np.stack([rad * np.cos(th), rad * np.sin(th), z], -1).astype(np.float32))

    @jax.jit
    def make_pyramid(c, m):
        res = jax.vmap(lambda pc, mm: q.quantize(pc, mm, spec.capacities[0],
                                                 need_index=False))(c, m)
        return j_build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)

    pyr = make_pyramid(c2, jnp.ones((2, N_POINTS), bool))
    variables = _perturb_bn(jax.jit(lambda k, p: built_j.model.init(k, p, q, train=False))(
        jax.random.PRNGKey(0), pyr), np.random.default_rng(1))

    jev = JGLEvaluator(root, "synthetic", eval_p, built_j, num_points=N_POINTS, batch_size=8,
                       n_k=N_K, n_hypotheses=N_HYP)
    j_global, j_local = jev.evaluate(variables)
    # the embeddings again, from the compiled forward
    j_map = jev.compute_embeddings(variables, jev.eval_set.map_set, with_local=True,
                                   n_k=max(N_K))
    j_query = jev.compute_embeddings(variables, jev.eval_set.query_set, with_local=True,
                                     n_k=max(N_K))

    built_t = create_egonn_model(_MP(), cap0=CAP0, device="cpu")
    load_flax_variables(built_t.model, variables)
    return dict(root=root, eval_p=eval_p, variables=variables, jev=jev, j_global=j_global,
                j_local=j_local, j_map=j_map, j_query=j_query, built_t=built_t)


def _align(got, want, tol=1e-6):
    """Per cloud, the rank in `got` of each of `want`'s selected keypoints
    (matched by position, within 1e-3 m), and how many moved.  The two
    orders may differ only by a near-tie of sigma: a keypoint found at
    another rank has, at that rank on JAX's side, a sigma within `tol`
    (relative) of its own.  Invalid ranks map to themselves."""
    b, k = want["kp_valid"].shape
    perm = np.tile(np.arange(k), (b, 1))
    moved = 0
    for i in range(b):
        for r in np.nonzero(want["kp_valid"][i])[0]:
            d = np.linalg.norm(got["keypoints"][i] - want["keypoints"][i, r], axis=1)
            d[~got["kp_valid"][i]] = np.inf
            r2 = int(np.argmin(d))
            assert d[r2] <= 1e-3, f"cloud {i}: JAX's keypoint {r} not selected by the port"
            if r2 != r:
                moved += 1
                assert abs(want["sigma"][i, r2] - want["sigma"][i, r]) <= \
                    tol * want["sigma"][i, r], f"cloud {i} rank {r}: no near-tie"
            perm[i, r] = r2
    return perm, moved


def _compare_local_embeddings(got, want):
    """global (rel 1e-4) and keypoints / descriptors / sigma at
    tests/test_torch_model.py's tolerances, validity equal, after aligning
    near-tie swaps of the sigma order; returns (the alignment, swaps)."""
    rel = np.abs(got["global"] - want["global"]).max() / np.abs(want["global"]).max()
    assert rel <= 1e-4, rel
    np.testing.assert_array_equal(got["kp_valid"], want["kp_valid"])
    perm, moved = _align(got, want)
    v = want["kp_valid"]

    def aligned(key):
        return np.take_along_axis(got[key], perm[..., None] if got[key].ndim == 3 else perm, 1)

    np.testing.assert_allclose(aligned("keypoints")[v], want["keypoints"][v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(aligned("descriptors")[v], want["descriptors"][v], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(aligned("sigma")[v], want["sigma"][v], rtol=1e-4, atol=0)
    return perm, moved


def test_embeddings_match_jax(setup):
    ev = GLEvaluator(setup["root"], "synthetic", setup["eval_p"], setup["built_t"],
                     num_points=N_POINTS, n_k=N_K, n_hypotheses=N_HYP)
    swaps = 0
    for subset, want in ((ev.eval_set.map_set, setup["j_map"]),
                         (ev.eval_set.query_set, setup["j_query"])):
        got = ev.compute_embeddings(subset, with_local=True, n_k=max(N_K))
        assert set(got) == set(want)
        assert all(got[k].shape == want[k].shape for k in want)
        swaps += _compare_local_embeddings(got, want)[1]
        no_local = ev.compute_embeddings(subset)
        assert set(no_local) == {"global"}
        np.testing.assert_array_equal(no_local["global"], got["global"])
    assert ev.band_ok == setup["jev"].band_ok == {}
    assert ev.capacity_ok == setup["jev"].capacity_ok
    assert swaps <= 4, swaps  # these clouds: one pair of ranks within 1e-7 of sigma


def test_recall_matches_jax(setup):
    """compute_recall on the same embeddings equals JAX's, and the port's
    Evaluator from its own embeddings gives JAX's recall dicts."""
    jev = setup["jev"]
    ev = Evaluator(setup["root"], "synthetic", setup["eval_p"], setup["built_t"],
                   num_points=N_POINTS)
    j_map, j_query = setup["j_map"]["global"], setup["j_query"]["global"]
    for got, want in ((ev.compute_recall(j_map, j_query), jev.compute_recall(j_map, j_query)),
                      (ev.evaluate(), setup["j_global"])):
        assert got["recall"].keys() == want["recall"].keys()
        for r in want["recall"]:
            np.testing.assert_array_equal(got["recall"][r], want["recall"][r])
        assert got["one_percent_recall"] == want["one_percent_recall"]
        np.testing.assert_array_equal(got["top1_ndx"], want["top1_ndx"])


def test_gl_evaluate_matches_jax_from_jax_draws(setup, monkeypatch):
    """GLEvaluator.evaluate with JAX's RANSAC draws handed over: the recall,
    pair count, success rate and inlier / match means equal, the pose errors
    and repeatability within f32 rounding."""
    jev, j_local = setup["jev"], setup["j_local"]
    top1 = setup["j_global"]["top1_ndx"]
    map_pos, query_pos = jev.eval_set.get_map_positions(), jev.eval_set.get_query_positions()
    eligible = [i for i in range(len(query_pos))
                if np.linalg.norm(query_pos[i] - map_pos[top1[i]]) <= 20.0]
    assert len(eligible) >= 2
    qi, mi = np.asarray(eligible), top1[eligible]
    ev = GLEvaluator(setup["root"], "synthetic", setup["eval_p"], setup["built_t"],
                     num_points=N_POINTS, n_k=N_K, n_hypotheses=N_HYP)
    jq, jm = setup["j_query"], setup["j_map"]
    # a draw names a query keypoint by its rank: JAX's ranks to the port's
    perm, _ = _compare_local_embeddings(
        ev.compute_embeddings(ev.eval_set.query_set, with_local=True, n_k=max(N_K)), jq)
    keys = jax.random.split(jax.random.PRNGKey(0), len(qi))
    draws = {}
    for n_k in N_K:
        assert (perm[:, :n_k] < n_k).all()
        draws[n_k] = torch.from_numpy(np.stack([perm[q][_jax_draws(np.asarray(j_mutual_matches(
            jnp.asarray(jq["descriptors"][q, :n_k]), jnp.asarray(jq["kp_valid"][q, :n_k]),
            jnp.asarray(jm["descriptors"][m, :n_k]), jnp.asarray(jm["kp_valid"][m, :n_k]))[1]),
            keys[j])] for j, (q, m) in enumerate(zip(qi, mi))]))

    real = t_evaluator.ransac_6dof
    calls = []

    def with_jax_draws(*args, n_hypotheses, gen):
        calls.append(args[0].shape)
        return real(*args, n_hypotheses=n_hypotheses, samples=draws[args[0].shape[1]])

    monkeypatch.setattr(t_evaluator, "ransac_6dof", with_jax_draws)
    g, local = ev.evaluate()
    assert calls == [(len(qi), max(N_K), 3)] * 2 * len(N_K)  # warm-up and timed call
    np.testing.assert_array_equal(g["top1_ndx"], top1)
    for r in g["recall"]:
        np.testing.assert_array_equal(g["recall"][r], setup["j_global"]["recall"][r])
    assert local.keys() == j_local.keys()
    for n_k, want in j_local.items():
        got = local[n_k]
        assert got.keys() == want.keys()
        for key in ("n_pairs", "success_rate", "mean_inliers", "mean_matches"):
            assert got[key] == want[key], key
        for key in ("rte", "rte_all", "repeatability", "repeatability_refined"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)
        for key in ("rre", "rre_all"):  # degrees from an f32 arccos
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3, err_msg=key)
        assert got["t_ransac"] > 0


def test_gl_evaluate_traced_and_icp_refined(setup, tmp_path, monkeypatch):
    """With EGONN_TRACE_DIR the first evaluation writes a profiler trace
    with the eval_embed and eval_ransac ranges (a second one is not traced);
    icp_refine adds the *_refined metrics against the ICP-refined ground
    truth, which `_icp_refine_gt` takes from `ops/icp.py`."""
    import json

    from egonn_tpu.ops.icp import icp as j_icp

    monkeypatch.setenv("EGONN_TRACE_DIR", str(tmp_path))
    ev = GLEvaluator(setup["root"], "synthetic", setup["eval_p"], setup["built_t"],
                     num_points=N_POINTS, n_k=N_K, n_hypotheses=N_HYP, debug=True,
                     icp_refine=True)
    g, local = ev.evaluate()
    events = json.loads((tmp_path / "gl_eval" / "trace.json").read_text())["traceEvents"]
    assert {"eval_embed", "eval_ransac"} <= {e.get("name") for e in events}
    (tmp_path / "gl_eval" / "trace.json").unlink()
    ev.evaluate()
    assert not (tmp_path / "gl_eval" / "trace.json").exists()
    st = local[N_K[0]]
    assert st["n_pairs"] >= 1, st
    for key in ("success_rate_refined", "rte_refined", "rre_refined", "rte_all_refined",
                "rre_all_refined"):
        assert key in st and (np.isfinite(st[key]) or key in ("rte_refined", "rre_refined"))
    q, m = 0, int(g["top1_ndx"][0])
    t_gt = ev._gt_relative_pose(ev.eval_set.query_set[q].pose, ev.eval_set.map_set[m].pose)
    pc1 = ev.pc_loader(os.path.join(setup["root"], ev.eval_set.query_set[q].rel_scan_filepath))
    pc2 = ev.pc_loader(os.path.join(setup["root"], ev.eval_set.map_set[m].rel_scan_filepath))
    np.testing.assert_allclose(ev._icp_refine_gt(q, m, t_gt), j_icp(pc1, pc2, t_gt),
                               rtol=0, atol=1e-6)


def test_n_samples_and_saliency_ablation_match_jax(setup):
    """--n_samples takes JAX's query stride; --ignore_keypoint_saliency draws
    JAX's random keypoint order (one generator per batch)."""
    jev = setup["jev"]
    j_abl = JGLEvaluator(setup["root"], "synthetic", setup["eval_p"], jev.built,
                         num_points=N_POINTS, batch_size=8, n_k=N_K, n_hypotheses=N_HYP,
                         n_samples=5, ignore_keypoint_saliency=True)
    j_abl._forward, j_abl.band_ok = jev._forward, jev.band_ok  # the compiled forward
    ev = GLEvaluator(setup["root"], "synthetic", setup["eval_p"], setup["built_t"],
                     num_points=N_POINTS, n_k=N_K, n_hypotheses=N_HYP, n_samples=5,
                     ignore_keypoint_saliency=True)
    assert [e.timestamp for e in ev.eval_set.query_set] == \
        [e.timestamp for e in j_abl.eval_set.query_set]
    assert len(ev.eval_set.query_set) == 5
    want = j_abl.compute_embeddings(setup["variables"], j_abl.eval_set.query_set,
                                    with_local=True, n_k=max(N_K))
    got = ev.compute_embeddings(ev.eval_set.query_set, with_local=True, n_k=max(N_K))
    _compare_local_embeddings(got, want)
    sig = np.where(got["kp_valid"], got["sigma"], np.nan)
    assert any(np.any(np.diff(row[~np.isnan(row)]) < 0) for row in sig)  # not by sigma


def test_rotation_evaluator_at_zero_equals_evaluator(setup):
    kw = dict(num_points=N_POINTS)
    base = Evaluator(setup["root"], "synthetic", setup["eval_p"], setup["built_t"], **kw)
    rot = RotationEvaluator(setup["root"], "synthetic", setup["eval_p"], setup["built_t"],
                            thetas_deg=[0.0, 90.0], **kw)
    want, got = base.evaluate(), rot.evaluate()
    assert list(got) == [0.0, 90.0]
    for r in want["recall"]:
        np.testing.assert_array_equal(got[0.0]["recall"][r], want["recall"][r])
    np.testing.assert_array_equal(got[0.0]["top1_ndx"], want["top1_ndx"])
    assert type(rot.pc_loader) is type(base.pc_loader)  # the loader restored


def test_auto_capacity_calibration(setup, monkeypatch):
    """EGONN_AUTO_CAPCALIB=1 refits the table to the map scans before the
    first forward (cap0 4096 over 512 points: no level truncates, the deep
    ones shrink): the fitted table is calibrate_capacities', every level
    holds, and the embeddings equal the unfitted evaluator's (where no level
    truncates, capacities are padding only)."""
    built = create_egonn_model(_MP(), cap0=4096, device="cpu")
    built.model.load_state_dict(setup["built_t"].model.state_dict())
    kw = dict(num_points=N_POINTS)
    plain = Evaluator(setup["root"], "synthetic", setup["eval_p"], built, **kw)
    e_plain = plain.compute_embeddings(plain.eval_set.map_set)
    monkeypatch.setenv("EGONN_AUTO_CAPCALIB", "1")
    fit = Evaluator(setup["root"], "synthetic", setup["eval_p"], built, **kw)
    e_fit = fit.compute_embeddings(fit.eval_set.map_set)
    fitted = fit.built.pyramid_spec.capacities
    sample = fit.eval_set.map_set[:16]
    clouds, mask = fit.load_clouds(sample, len(sample))
    assert fitted == calibrate_capacities(clouds, mask, built.quantizer, built.pyramid_spec,
                                          device=torch.device("cpu"))
    assert fitted != built.pyramid_spec.capacities and fitted[0] == 4096
    assert fitted[-1] <= built.pyramid_spec.capacities[-1]
    assert fit.built is not built and built.pyramid_spec.capacities[0] == 4096
    assert all(ok for _, _, ok in plain.capacity_ok.values()), plain.capacity_ok
    assert all(ok for _, _, ok in fit.capacity_ok.values()), fit.capacity_ok
    np.testing.assert_allclose(e_fit["global"], e_plain["global"], rtol=1e-5, atol=1e-6)


def test_evaluate_cli(setup, tmp_path, capsys):
    """`python -m egonn_tpu_torch.evaluate --device cpu` prints the recall and
    6DoF lines; --dp and a card that is not there stop it; the rotations
    CLI reads a port checkpoint."""
    config = tmp_path / "egonn_small.txt"
    config.write_text(SMALL_CONFIG)
    args = ["--dataset_root", setup["root"], "--dataset_type", "synthetic", "--eval_set",
            setup["eval_p"], "--model_config", str(config)]
    out = subprocess.run([sys.executable, "-m", "egonn_tpu_torch.evaluate", *args, "--device",
                          "cpu", "--n_k", "16", "--ransac_hypotheses", "64",
                          "--ignore_keypoint_regressor"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True).stdout
    assert "Radius: 5 [m] : Recall@N:" in out and "Radius: 20 [m] : Recall@N:" in out
    assert "Ignore keypoints regressor: True" in out
    assert "WARNING: evaluating a randomly initialized model" in out
    with pytest.raises(SystemExit, match="A.9"):
        t_evaluate_cli.main(args + ["--dp", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            t_evaluate_cli.main(args)
    with pytest.raises(SystemExit, match="orbax"):
        t_evaluate_cli.main(args + ["--device", "cpu", "--weights", str(tmp_path)])

    ckpt = str(tmp_path / "ckpt")
    model = setup["built_t"].model
    save_checkpoint(ckpt, TrainState(model, torch.optim.Adam(model.parameters())), step=3)
    capsys.readouterr()
    t_evaluate_cli.main(args + ["--device", "cpu", "--weights", ckpt, "--global_only"])
    out = capsys.readouterr().out
    assert "Loaded checkpoint step 3" in out and "Recall@1:" in out
    t_rotations_cli.main(args + ["--device", "cpu", "--weights", ckpt, "--step_deg", "90",
                                 "--out", str(tmp_path / "rot.pickle")])
    out = capsys.readouterr().out
    assert "theta=  0.0 deg" in out and "theta= 90.0 deg" in out and "theta=180.0 deg" in out
    assert (tmp_path / "rot.pickle").exists()
