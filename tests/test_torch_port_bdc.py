"""BDC pool of the PyTorch port against the JAX package: the plain version
against the XLA ``bdc_pool`` and the Pallas ``bdc_pool_fused`` (interpret
mode), the ``triuvec`` order, and the CUDA kernel's wrapper and build helper
as far as they run without a card.  The kernel itself is held against the
plain version on the card by ``chip_smoke.py``."""

import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.ops.bdc import bdc_pool as jax_bdc_pool  # noqa: E402
from audio_fewshot_tpu.ops.bdc import triu_indices_flat as jax_triu_indices_flat  # noqa: E402
from audio_fewshot_tpu.ops.bdc import triuvec as jax_triuvec  # noqa: E402
from audio_fewshot_tpu.ops.bdc_pallas import bdc_pool_fused  # noqa: E402
from audio_fewshot_tpu_torch.ops import bdc_cuda, build  # noqa: E402
from audio_fewshot_tpu_torch.ops.bdc import bdc_pool, triu_indices_flat, triuvec  # noqa: E402

# float32 throughout; the gram sums 304 products in another order than XLA
ATOL = 5e-4


@pytest.mark.parametrize(
    "shape,log_t,seed",
    [((4, 64, 304), float(np.log(1 / 608.0)), 0), ((2, 16, 45), 0.0, 1)],
)
def test_plain_bdc_matches_jax_xla_and_pallas(shape, log_t, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    lt = np.float32(log_t)
    ours = bdc_pool(torch.from_numpy(x), torch.tensor(lt)).numpy()
    xla = np.asarray(jax_bdc_pool(jnp.asarray(x), jnp.asarray(lt)))
    pallas = np.asarray(bdc_pool_fused(jnp.asarray(x), jnp.asarray(lt), interpret=True))
    np.testing.assert_allclose(ours, xla, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


@pytest.mark.parametrize("d", [1, 5, 64])
def test_triuvec_order_matches_jax(d):
    np.testing.assert_array_equal(triu_indices_flat(d), jax_triu_indices_flat(d))
    mat = np.random.default_rng(d).normal(size=(3, d, d)).astype(np.float32)
    np.testing.assert_array_equal(
        triuvec(torch.from_numpy(mat)).numpy(), np.asarray(jax_triuvec(jnp.asarray(mat)))
    )


def test_wrapper_runs_plain_version_on_cpu(monkeypatch):
    monkeypatch.setattr(bdc_cuda, "launches", 0)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 20, 33)).astype(np.float32))
    log_t = torch.full((1, 1), -3.0)
    tri, full = bdc_cuda.bdc_pool_triu(x, log_t, return_full=True)
    assert bdc_cuda.launches == 0
    assert tri.shape == (3, 20 * 21 // 2) and full.shape == (3, 20, 20)
    torch.testing.assert_close(full, bdc_pool(x, log_t), rtol=0, atol=0)
    torch.testing.assert_close(tri, triuvec(full), rtol=0, atol=0)
    torch.testing.assert_close(bdc_cuda.bdc_pool_triu(x, log_t), tri, rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    x = torch.zeros((2, 8, 5), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        bdc_cuda.bdc_pool_triu(x, torch.zeros((1, 1), device="meta"))


def _kernel_inputs(case):
    x = torch.zeros((2, 64, 10))
    log_t = torch.zeros((1, 1))
    if case == "d_above_limit":
        return torch.zeros((2, 129, 10)), log_t, ValueError
    if case == "float64":
        return x.double(), log_t, TypeError
    if case == "not_contiguous":
        return torch.zeros((2, 10, 64)).transpose(1, 2), log_t, ValueError
    if case == "log_t_size":
        return x, torch.zeros(2), ValueError
    if case == "needs_grad":
        return x, torch.zeros((1, 1), requires_grad=True), RuntimeError
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case", ["d_above_limit", "float64", "not_contiguous", "log_t_size", "needs_grad"]
)
def test_kernel_input_checks(case):
    x, log_t, err = _kernel_inputs(case)
    with pytest.raises(err):
        bdc_cuda.check_kernel_inputs(x, log_t)


def test_kernel_input_checks_accept_the_supported_range():
    bdc_cuda.check_kernel_inputs(torch.zeros((2, 128, 7)), torch.zeros((1, 1)))
    bdc_cuda.check_kernel_inputs(torch.zeros((1, 1, 1)), torch.zeros(()))
    with torch.no_grad():  # grad-requiring inputs are fine without autograd
        bdc_cuda.check_kernel_inputs(
            torch.zeros((2, 64, 7), requires_grad=True), torch.zeros((1, 1))
        )


def test_kernel_source_ships_with_a_c_entry():
    text = bdc_cuda.SOURCE.read_text()
    assert 'extern "C" int bdc_pool_launch' in text
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def _fake_nvcc(tmp_path, exit_code=0):
    """A stand-in for nvcc: records each call and writes the -o file."""
    script = tmp_path / "bin" / "nvcc"
    script.parent.mkdir()
    script.write_text(
        "#!/bin/sh\n"
        f'echo call >> "{tmp_path}/calls"\n'
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then out="$2"; fi\n'
        "  shift\n"
        "done\n"
        'echo "ptxas info    : Used 54 registers" >&2\n'
        f"[ {exit_code} -eq 0 ] && : > \"$out\"\n"
        f"exit {exit_code}\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script


def _isolate_toolkit(monkeypatch, tmp_path, path_dir):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(path_dir))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    _isolate_toolkit(monkeypatch, tmp_path, tmp_path)
    with pytest.raises(FileNotFoundError, match="nvcc"):
        build.find_nvcc()
    with pytest.raises(FileNotFoundError, match="nvcc"):
        build.build_library("bdc_pool", [bdc_cuda.SOURCE])


def test_build_caches_by_source_hash(monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path)
    _isolate_toolkit(monkeypatch, tmp_path, nvcc.parent)
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first = build.build_library("k", [src])
    assert first.is_file() and first.parent == tmp_path / "kernels"
    assert "registers" in first.with_suffix(".log").read_text()
    assert build.build_library("k", [src]) == first  # reused, nvcc not run again
    src.write_text("// v2\n")
    second = build.build_library("k", [src])
    assert second != first and second.is_file()
    assert (tmp_path / "calls").read_text().count("call") == 2
    # CUDA_HOME wins over PATH
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", "")
    assert build.find_nvcc() == os.path.join(str(tmp_path), "bin", "nvcc")


def test_build_failure_leaves_no_library(monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path, exit_code=2)
    _isolate_toolkit(monkeypatch, tmp_path, nvcc.parent)
    src = tmp_path / "k.cu"
    src.write_text("// broken\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build_library("k", [src])
    assert not list((tmp_path / "kernels").glob("*.so*"))
