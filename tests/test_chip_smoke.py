"""chip_smoke.py's phases at a small size on the CPU (the script itself
refuses any platform but a GPU; its phase functions do not)."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from vectorsearch_tpu.quant import codec  # noqa: E402


def test_dequantize_wire_matches_codec():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(50, 24)).astype(np.float32)
    wire = codec.quantize(v)
    np.testing.assert_allclose(
        chip_smoke.dequantize_wire(wire), codec.dequantize(wire, np.float64),
        rtol=1e-6, atol=1e-6,
    )


def test_exact_topk_matches_full_sort():
    rng = np.random.default_rng(1)
    corpus = rng.normal(size=(250_000, 8))
    q = rng.normal(size=(3, 8))
    s, i = chip_smoke.exact_topk(corpus, q, k=5)
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    full = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ cn.T
    want = np.argsort(-full, axis=1)[:, :5]
    assert np.array_equal(i, want)
    np.testing.assert_allclose(s, np.take_along_axis(full, want, 1))


def test_check_exact_allows_only_ties():
    rng = np.random.default_rng(2)
    corpus = rng.normal(size=(40, 6))
    q = rng.normal(size=(2, 6))
    ref_s, ref_i = chip_smoke.exact_topk(corpus, q, k=4)
    assert chip_smoke.check_exact(ref_i, ref_s, ref_s, ref_i, corpus, q) < 1e-12
    swapped = ref_i.copy()
    swapped[0, [0, 3]] = swapped[0, [3, 0]]
    with pytest.raises(AssertionError):
        chip_smoke.check_exact(swapped, ref_s, ref_s, ref_i, corpus, q)


def test_served_path_small(tmp_path):
    """Every one-card phase end to end at 3000 x 64: boot, kernel check,
    k-means rebuild, search against both references, insert/delete, and
    HTTP through build_app."""
    from vectorsearch_tpu.store import Store

    n, dim, k = 3000, 64, 30
    centers, assign, data, queries = chip_smoke.make_corpus(n, dim, k, 0, 16)
    new_docs = centers[:10] * np.float32(2.0) + np.random.default_rng(
        1
    ).standard_normal((10, dim), dtype=np.float32)
    wires = codec.quantize(data)
    store = Store(str(tmp_path / "store.db"))
    cat_id = chip_smoke.populate_store(store, wires, centers, assign)
    eng, cat = chip_smoke.phase_boot(
        store, chip_smoke.SeededEmbedder(queries, new_docs)
    )
    try:
        assert cat["live_vectors"] == n and cat["clusters"] == k
        ivf = eng._state_for(cat_id, create=False).ivf
        assert chip_smoke.phase_kernel(ivf, queries) <= 1e-4
        st = chip_smoke.phase_rebuild(eng, cat_id, k)
        assert st["live_vectors"] == n and st["clusters"] >= k * 9 // 10
        report = chip_smoke.phase_search(
            eng, len(queries), chip_smoke.dequantize_wire(wires), data,
            queries, threads=8,
        )
        assert report[-1]["max_score_err_vs_f64"] <= 1e-4
        assert report[8]["recall_at_10_vs_f32"] >= 0.95
        assert report[1]["rows_per_dispatch_32_threads"] >= 1
        out = chip_smoke.phase_mutate(eng, 10, n)
        assert out["found_first"] and out["deleted_gone"]
        http = chip_smoke.phase_http(eng)
        assert http["search_hits"] == 10
    finally:
        eng.close()
        store.close()


def test_phase_four_on_four_cpu_devices():
    """The --four comparison on four of the test mesh's virtual devices."""
    out = chip_smoke.phase_four(4000, 64, 40, seed=0, n_queries=8)
    assert out["ids_equal"] and len(out["devices"]) == 4
    assert out["max_score_diff"] <= 1e-4


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    assert capsys.readouterr().out == ""


def test_script_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
