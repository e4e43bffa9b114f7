"""The port's served ImageNetSiftLcsFV pipeline held against the JAX package.

One small pipeline (gmm_k=4, pca_dims=8, 5 classes, 32×32 images) is built
in both packages from the same numpy parameters; the JAX side runs SIFT on
its XLA backend and the Fisher vectors through its Pallas kernel (interpreter
mode on the CPU). Features are compared at rtol 1e-4, atol 1e-5 (float32
with sums in another order), scores at rtol 1e-4, atol 1e-6, and top-k
indices exactly on scores without ties. A further case carries the PCA and
GMM of a JAX fit into the port through ``convert.params_from_numpy``.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import keystone_tpu_torch.ops.fisher_vector as port_fv
from keystone_tpu.loaders.imagenet import ImageNetLoader as JImageNetLoader
from keystone_tpu.nodes.images import GrayScaler as JGrayScaler
from keystone_tpu.nodes.images import LCSExtractor as JLCSExtractor
from keystone_tpu.nodes.images.external import SIFTExtractor as JSIFTExtractor
from keystone_tpu.nodes.images.external.fisher_vector import (
    FisherVector as JFisherVector,
    fit_fisher_featurizer,
)
from keystone_tpu.nodes.learning import BlockLinearMapper as JBlockLinearMapper
from keystone_tpu.nodes.learning import PCATransformer as JPCATransformer
from keystone_tpu.nodes.stats import SignedHellingerMapper as JSignedHellingerMapper
from keystone_tpu.nodes.stats.normalizer import L2Normalizer as JL2Normalizer
from keystone_tpu.nodes.util import TopKClassifier as JTopKClassifier
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch.convert import params_from_numpy
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as port
from keystone_tpu_torch.workflow import FusedTransformer, on_device
from keystone_tpu_torch.workflow.serving import CompiledPipeline, bucket_for, pow2_ladder

K, P, C, SIZE = 4, 8, 5, 32
CONF = port.ImageNetSiftLcsFVConfig(gmm_k=K, pca_dims=P, top_k=3)
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)
SCORE_TOL = dict(rtol=1e-4, atol=1e-6)
PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "keystone_tpu_torch"


def _jax(out):
    return np.asarray(out.get() if hasattr(out, "get") else out)


def _images(n=5, seed=0):
    return JImageNetLoader.synthetic(n=8, num_classes=3, size=SIZE, seed=seed)[0].data[:n]


def _numpy_params(seed=0):
    rng = np.random.default_rng(seed)
    d = {}
    for br, width in (("sift", 128), ("lcs", 96)):
        comps, _ = np.linalg.qr(rng.normal(size=(width, P)))
        d[f"{br}.pca.components"] = comps.astype(np.float32)
        d[f"{br}.pca.mean"] = (0.1 * rng.normal(size=width)).astype(np.float32)
        w = rng.uniform(0.2, 1.0, size=K).astype(np.float32)
        d[f"{br}.gmm.weights"] = w / w.sum()
        d[f"{br}.gmm.means"] = (0.2 * rng.normal(size=(K, P))).astype(np.float32)
        d[f"{br}.gmm.variances"] = rng.uniform(0.5, 1.5, size=(K, P)).astype(np.float32)
    D = CONF.feature_dim
    d["head.W"] = rng.normal(size=(D, C)).astype(np.float32)
    d["head.blocks"] = np.array([(0, 24), (24, D)])
    d["head.b"] = rng.normal(size=C).astype(np.float32)
    return d


def _jax_featurizer(d):
    fronts = {
        "sift": JGrayScaler().and_then(JSIFTExtractor(backend="xla")),
        "lcs": JLCSExtractor().to_pipeline(),
    }
    return JPipeline.gather([
        fronts[br]
        .and_then(JPCATransformer(d[f"{br}.pca.components"], d[f"{br}.pca.mean"]))
        .and_then(JFisherVector(
            d[f"{br}.gmm.weights"], d[f"{br}.gmm.means"], d[f"{br}.gmm.variances"],
            backend="pallas",
        ))
        .and_then(JSignedHellingerMapper())
        .and_then(JL2Normalizer())
        for br in ("sift", "lcs")
    ])


def _jax_head(d):
    W = d["head.W"]
    blocks = [tuple(int(v) for v in se) for se in d["head.blocks"]]
    return JBlockLinearMapper([W[s:e] for s, e in blocks], blocks, d["head.b"])


def test_serving_pipeline_matches_jax():
    d = _numpy_params()
    X = _images()
    j_feats = _jax(_jax_featurizer(d)(X))
    j_scores = _jax(_jax_featurizer(d).and_then(_jax_head(d))(X))
    j_topk = _jax(
        _jax_featurizer(d).and_then(_jax_head(d)).and_then(JTopKClassifier(3))(X)
    )

    params = params_from_numpy(d, device="cpu")
    Xt = torch.from_numpy(X)
    with torch.inference_mode(), on_device("cpu"):
        feats = port.build_featurizer(params, CONF)(Xt).get().numpy()
        pipe = port.build_serving_pipeline(params, CONF)
        scores = port.build_featurizer(params, CONF).and_then(params.head)(Xt).get().numpy()
        topk = pipe(Xt).get().numpy()
    assert feats.shape == (5, CONF.feature_dim)
    np.testing.assert_allclose(feats, j_feats, **FEAT_TOL)
    np.testing.assert_allclose(scores, j_scores, **SCORE_TOL)
    # Tie-free scores, so both top-k's orders are defined.
    gaps = np.diff(np.sort(j_scores, axis=1), axis=1)
    assert gaps.min() > 1e-3
    assert topk.dtype == np.int32
    np.testing.assert_array_equal(topk, j_topk)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_compiled_pipeline_matches_direct_call(n):
    params = params_from_numpy(_numpy_params(), device="cpu")
    scorer = port.build_featurizer(params, CONF).and_then(params.head)
    engine = CompiledPipeline(scorer, max_batch=4, devices=["cpu"])
    engine.warmup((SIZE, SIZE, 3))
    assert engine.ladder == (1, 2, 4)
    X = _images(n, seed=1)
    got = engine(X)
    with torch.inference_mode():
        want = engine.transformer(torch.from_numpy(X)).numpy()
    assert got.shape == (n, C)
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    # n=5 is over the top bucket: one chunk of 4, one of 1 padded to 1.
    served = {1: {1: 2, 2: 1, 4: 1}, 3: {1: 1, 2: 1, 4: 2}, 5: {1: 2, 2: 1, 4: 2}}[n]
    assert dict(engine.calls_by_bucket) == served


def test_ladder_and_buckets():
    assert pow2_ladder(64) == (1, 2, 4, 8, 16, 32, 64)
    assert pow2_ladder(48) == (1, 2, 4, 8, 16, 32, 48)
    assert [bucket_for(n, (1, 2, 4)) for n in (1, 2, 3, 4, 5)] == [1, 2, 4, 4, None]
    with pytest.raises(ValueError):
        pow2_ladder(0)


def test_synthetic_loader_is_a_copy():
    a, b = ImageNetLoader.synthetic(n=8, num_classes=3, size=SIZE, seed=2)
    ja, jb = JImageNetLoader.synthetic(n=8, num_classes=3, size=SIZE, seed=2)
    np.testing.assert_array_equal(a.data, ja.data)
    np.testing.assert_array_equal(b.labels, jb.labels)


def _fitted(pipeline, cls):
    found = [
        op.transformer for op in pipeline.graph.operators.values()
        if isinstance(getattr(op, "transformer", None), cls)
    ]
    assert len(found) == 1
    return found[0]


def _branch_features64(D, comps, mean, w, mu, var):
    """One branch's features from its descriptors, in float64 numpy and in
    the direct form (x − μ)²/σ²: PCA → Fisher vector → signed sqrt → L2."""
    D, comps, mean, w, mu, var = (np.asarray(a, np.float64) for a in (D, comps, mean, w, mu, var))
    X = (D - mean) @ comps  # (B, m, p)
    B, m, _ = X.shape
    w = np.maximum(w, 1e-12)
    diff = X[:, :, None, :] - mu  # (B, m, k, p)
    log_p = np.log(w) - 0.5 * (
        (diff**2 / var).sum(-1) + np.log(2 * np.pi * var).sum(-1)
    )
    log_p -= log_p.max(-1, keepdims=True)
    r = np.exp(log_p)
    r /= r.sum(-1, keepdims=True)  # (B, m, k)
    gmu = np.einsum("bmk,bmkp->bkp", r, diff / np.sqrt(var)) / (m * np.sqrt(w))[:, None]
    gvar = np.einsum("bmk,bmkp->bkp", r, diff**2 / var - 1) / (m * np.sqrt(2 * w))[:, None]
    f = np.concatenate([gmu.reshape(B, -1), gvar.reshape(B, -1)], axis=1)
    f = np.sign(f) * np.sqrt(np.abs(f))
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def test_weights_carried_across_from_a_jax_fit():
    """The JAX fit's PCA and GMM arrays reach the port's buffers unchanged,
    and the port's features are as close to exact arithmetic as the
    reference's own.

    A tiny fit puts GMM variances near the fit's 1e-4 floor (1e-4 to 1e-3
    in both branches here). There the expanded quadratic form that both
    packages evaluate in float32 loses most digits to cancellation
    (x²/σ² ≈ 10³ against results of order 1), and the signed square root
    magnifies what is lost near 0: the reference's own features are several
    hundredths off a float64 evaluation of the same chain, so two float32
    evaluations cannot meet FEAT_TOL elementwise.
    The check is therefore that the port's error against float64 is at most
    twice the reference's, plus FEAT_TOL's atol."""
    train = _images(6, seed=3)
    fronts = {
        "sift": JGrayScaler().and_then(JSIFTExtractor(backend="xla")),
        "lcs": JLCSExtractor().to_pipeline(),
    }
    d, j_feats, exact = {}, [], []
    for seed, (br, front) in enumerate(fronts.items()):
        branch = fit_fisher_featurizer(
            front, train, pca_dims=P, gmm_k=K, em_iters=3, sample_size=500,
            backend="pallas", seed=seed,
        )
        j_feats.append(_jax(branch(train)))
        pca = _fitted(branch, JPCATransformer)
        fv = _fitted(branch, JFisherVector)
        d[f"{br}.pca.components"] = np.array(pca.components)
        d[f"{br}.pca.mean"] = np.array(pca.mean)
        d[f"{br}.gmm.weights"] = fv.weights
        d[f"{br}.gmm.means"] = fv.means
        d[f"{br}.gmm.variances"] = fv.variances
        exact.append(_branch_features64(
            _jax(front(train)), pca.components, pca.mean, fv.weights, fv.means, fv.variances,
        ))
    d.update({k: v for k, v in _numpy_params().items() if k.startswith("head.")})
    params = params_from_numpy(d, device="cpu")
    for br in ("sift", "lcs"):
        pca, fv = getattr(params, f"{br}_pca"), getattr(params, f"{br}_fv")
        np.testing.assert_array_equal(pca.components.numpy(), d[f"{br}.pca.components"])
        np.testing.assert_array_equal(pca.mean.numpy(), d[f"{br}.pca.mean"])
        for key in ("weights", "means", "variances"):
            np.testing.assert_array_equal(getattr(fv, key).numpy(), d[f"{br}.gmm.{key}"])
    with torch.inference_mode(), on_device("cpu"):
        feats = port.build_featurizer(params, CONF)(torch.from_numpy(train)).get().numpy()
    half = feats.shape[1] // 2
    for i, (j, ref) in enumerate(zip(j_feats, exact)):
        got = feats[:, i * half : (i + 1) * half]
        assert got.shape == j.shape
        port_err, jax_err = np.abs(got - ref).max(), np.abs(j - ref).max()
        assert port_err <= 2 * jax_err + FEAT_TOL["atol"], (i, port_err, jax_err)


def test_main_serves_on_the_cpu(capsys):
    out = port.main([
        "--device", "cpu", "--gmm-k", "4", "--pca-dims", "8", "--num-classes", "5",
        "--image-size", "32", "--max-batch", "4", "--requests", "1,5",
    ])
    assert [o.shape for o in out] == [(1, 5), (5, 5)]
    assert "request of 5" in capsys.readouterr().out


def test_package_imports_neither_jax_nor_the_reference():
    walked = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert {
        "linalg/bcd.py", "linalg/row_matrix.py", "nodes/learning/gmm.py",
        "nodes/learning/kmeans.py", "nodes/learning/kernels.py", "nodes/stats/samplers.py",
        "nodes/util/labels.py", "utils/stages.py", "loaders/stream.py", "utils/staging.py",
        "nodes/images/patches.py", "evaluation/augmented.py",
    } <= walked
    for path in PACKAGE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "keystone_tpu"), f"{path}: {name}"
    code = (
        "import importlib, pathlib, sys\n"
        f"root = pathlib.Path({str(PACKAGE.parent)!r})\n"
        "for p in sorted((root / 'keystone_tpu_torch').rglob('*.py')):\n"
        "    mod = '.'.join(p.relative_to(root).with_suffix('').parts)\n"
        "    importlib.import_module(mod.removesuffix('.__init__'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'keystone_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PACKAGE.parent, timeout=120)


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = _numpy_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.seeded_params(0, K, P, C)
    scorer = FusedTransformer([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledPipeline(scorer)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main(["--gmm-k", "4", "--pca-dims", "8"])


def test_cpu_tensors_never_count_kernel_launches():
    before = port_fv.LAUNCHES
    params = params_from_numpy(_numpy_params(), device="cpu")
    with torch.inference_mode(), on_device("cpu"):
        port.build_featurizer(params, CONF)(torch.from_numpy(_images(2))).get()
    assert port_fv.LAUNCHES == before
