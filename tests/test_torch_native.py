"""The port's C++ text engine (``native/``) against the JAX package's
``native`` and both packages' NumPy engines: bit-equal edit distances and
LCS alignments, ``merge_versions`` with and without it, the
``HOCR_TPU_NO_NATIVE`` switch, the fallback without g++, and a build at
first use (never at import) that concurrent processes share."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from handwritten_ocr_tpu import native as jax_native
from handwritten_ocr_tpu.text import merge as jax_merge
from handwritten_ocr_tpu.text import metrics as jax_metrics
from handwritten_ocr_tpu_torch import native
from handwritten_ocr_tpu_torch.text import merge, metrics

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    """Each test starts with the variable unset; the C++ engine must have
    built here (g++ is on this machine), as the JAX package's has."""
    monkeypatch.delenv("HOCR_TPU_NO_NATIVE", raising=False)
    assert native.engine() == "cpp", native.build_error()
    assert jax_native.available()


def _dp(a, b) -> int:
    """Scalar Levenshtein DP (the oracle)."""
    n, m = len(a), len(b)
    dp = np.zeros((n + 1, m + 1), dtype=int)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1,
                           dp[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
    return int(dp[n, m])


def _numpy_engines(a, b, monkeypatch) -> tuple[int, int]:
    """(the port's, the JAX package's) NumPy edit distance."""
    with monkeypatch.context() as m:
        m.setenv("HOCR_TPU_NO_NATIVE", "1")
        m.setattr(jax_metrics, "_native_edit_distance", None)
        return metrics.edit_distance_ids(a, b), jax_metrics.edit_distance_ids(a, b)


def test_edit_distance_fuzz_equals_every_engine(monkeypatch):
    rng = np.random.default_rng(0)
    for _ in range(200):
        a = rng.integers(0, 6, rng.integers(0, 40)).astype(np.uint32)
        b = rng.integers(0, 6, rng.integers(0, 40)).astype(np.uint32)
        want = _dp(a, b)
        assert native.edit_distance_u32(a, b) == want
        assert jax_native.edit_distance_u32(a, b) == want
        assert metrics.edit_distance_ids(a, b) == want
        assert _numpy_engines(a, b, monkeypatch) == (want, want)


@pytest.mark.parametrize("a,b,want", [
    ([], [], 0), ([], [1, 2, 3], 3), ([1, 2, 3], [], 3),
    ([7], [7], 0), ([2 ** 32 - 1], [0], 1)])
def test_edit_distance_empties_and_edges(a, b, want):
    a, b = np.array(a, dtype=np.uint32), np.array(b, dtype=np.uint32)
    assert native.edit_distance_u32(a, b) == want
    assert jax_native.edit_distance_u32(a, b) == want


def _backtrack(a, b) -> np.ndarray:
    """The NumPy table with the merge's tie-break (backbone first)."""
    table = merge._lcs_rows(a, b)
    out = np.full(len(a), -1, dtype=np.int64)
    i, j = len(a), len(b)
    while i > 0 and j > 0:
        if a[i - 1] == b[j - 1]:
            out[i - 1] = j - 1
            i, j = i - 1, j - 1
        elif table[i - 1, j] >= table[i, j - 1]:
            i -= 1
        else:
            j -= 1
    return out


def test_lcs_align_equals_jax_and_the_numpy_backtrack():
    rng = np.random.default_rng(1)
    for _ in range(200):
        a = rng.integers(0, 5, rng.integers(0, 25)).astype(np.int64)
        b = rng.integers(0, 5, rng.integers(0, 25)).astype(np.int64)
        got = native.lcs_align(a, b)
        np.testing.assert_array_equal(got, jax_native.lcs_align(a, b))
        np.testing.assert_array_equal(got, _backtrack(a, b))


VERSIONS = [
    ["the quick brown fox jumps", "The quick brown fax jumps",
     "the quick  brown fox"],
    ["a b c", "a x c", "y b c", "a b"],
    ["", "word"], ["only one"], [],
    ["Teh cat sat", "the cat sat on", "the hat sat", "THE cat"],
]


@pytest.mark.parametrize("versions", VERSIONS)
def test_merge_versions_with_and_without_native(versions, monkeypatch):
    with_native = merge.merge_versions(versions)
    assert with_native == jax_merge.merge_versions(versions)
    with monkeypatch.context() as m:
        m.setenv("HOCR_TPU_NO_NATIVE", "1")
        m.setattr(jax_merge, "_native_lcs_align", None)
        assert merge.merge_versions(versions) == with_native
        assert jax_merge.merge_versions(versions) == with_native
    if versions:
        backbone = versions[0].split()
        for other in versions:
            assert merge.align_to_backbone(backbone, other.split()) == \
                jax_merge.align_to_backbone(backbone, other.split())


def test_no_native_variable_forces_numpy(monkeypatch):
    monkeypatch.setenv("HOCR_TPU_NO_NATIVE", "1")
    assert not native.available() and native.engine() == "numpy"
    assert native.build_error() is None
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.edit_distance_u32(np.zeros(1, np.uint32), np.zeros(1, np.uint32))
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.lcs_align(np.zeros(1, np.int64), np.zeros(1, np.int64))
    assert metrics.levenshtein("kitten", "sitting") == 3
    monkeypatch.setenv("HOCR_TPU_NO_NATIVE", "")    # empty: on, as in JAX
    assert native.engine() == "cpp"


def test_without_gxx_the_numpy_engines_run(monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native._library.cache_clear()
    try:
        assert native.engine() == "numpy"
        assert native.build_error() == "g++ not found"
        assert metrics.tier1_metrics("the cat", "teh cat") == \
            jax_metrics.tier1_metrics("the cat", "teh cat")
    finally:
        native._library.cache_clear()


def test_importing_text_starts_no_compiler():
    code = (
        "import json, subprocess\n"
        "started = []\n"
        "init = subprocess.Popen.__init__\n"
        "def record(self, args, *rest, **kwargs):\n"
        "    started.append(str(args))\n"
        "    init(self, args, *rest, **kwargs)\n"
        "subprocess.Popen.__init__ = record\n"
        "import handwritten_ocr_tpu_torch.text\n"
        "import handwritten_ocr_tpu_torch.text.metrics\n"
        "from handwritten_ocr_tpu_torch import native\n"
        "print(json.dumps([started, native._library.cache_info().currsize]))\n")
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert json.loads(result.stdout.strip().splitlines()[-1]) == [[], 0]


def test_concurrent_first_use_builds_one_library(tmp_path):
    """Four processes reach first use together over an empty build
    directory: each gets a whole library (temp file + rename), every
    answer is right, and one library named by its digest is left."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from handwritten_ocr_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "a = np.array([1, 2, 3, 4], np.uint32)\n"
        "b = np.array([1, 3, 4, 5], np.uint32)\n"
        "print(native.engine(), native.edit_distance_u32(a, b))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err for _, err in outs]
    assert [out.split() for out, _ in outs] == [["cpp", "2"]] * 4
    built = sorted(tmp_path.iterdir())
    assert len(built) == 1
    assert built[0].name.startswith("libfasttext-") and \
        built[0].suffix == ".so"
