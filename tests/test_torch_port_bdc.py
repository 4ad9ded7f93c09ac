"""BDC pool of the PyTorch port against the JAX package: the plain version
against the XLA ``bdc_pool`` and the Pallas ``bdc_pool_fused`` (interpret
mode), the ``triuvec`` order, and the CUDA kernel's wrapper and build helper
as far as they run without a card.  The kernel itself is held against the
plain version and against float64 on the card by ``chip_smoke.py``; here the
plain emulation of its split-TF32 arithmetic (``gram_split_tf32``) bounds the
error of its design."""

import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.ops.bdc import bdc_pool as jax_bdc_pool  # noqa: E402
from audio_fewshot_tpu.ops.bdc import triu_indices_flat as jax_triu_indices_flat  # noqa: E402
from audio_fewshot_tpu.ops.bdc import triuvec as jax_triuvec  # noqa: E402
from audio_fewshot_tpu.ops.bdc_pallas import bdc_pool_fused  # noqa: E402
from audio_fewshot_tpu_torch.ops import bdc_cuda, build  # noqa: E402
from audio_fewshot_tpu_torch.ops.bdc import (  # noqa: E402
    bdc_from_gram,
    bdc_pool,
    gram_split_tf32,
    round_tf32,
    truncate_tf32,
    triu_indices_flat,
    triuvec,
)

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


def bdc_pool_split_tf32(x, log_t):
    """The BDC pool on the gram as the CUDA kernel computes it."""
    return bdc_from_gram(gram_split_tf32(x), log_t)


@pytest.mark.parametrize(
    "shape,log_t,seed",
    [((4, 64, 304), float(np.log(1 / 608.0)), 0), ((2, 16, 45), 0.0, 1)],
)
def test_split_tf32_bdc_matches_jax_xla_and_pallas(shape, log_t, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    lt = np.float32(log_t)
    ours = bdc_pool_split_tf32(torch.from_numpy(x), torch.tensor(lt)).numpy()
    xla = np.asarray(jax_bdc_pool(jnp.asarray(x), jnp.asarray(lt)))
    pallas = np.asarray(bdc_pool_fused(jnp.asarray(x), jnp.asarray(lt), interpret=True))
    np.testing.assert_allclose(ours, xla, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


def _adversarial(kind, shape, seed):
    """Inputs on which the gram's rounding shows most in the BDC matrix."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "post_relu":  # what BdcHead feeds the pool: >= 0, many exact zeros
        return np.maximum(x - np.float32(0.5), np.float32(0.0))
    if kind == "near_duplicate_rows":  # distances that cancel to (almost) nothing
        x[:, 1] = x[:, 0]
        x[:, 3] = x[:, 2] * np.float32(1 + 1e-4)
        x[:, 5] = x[:, 4] + np.float32(1e-3) * rng.normal(size=x[:, 4].shape).astype(np.float32)
        x[:, -1] = x[:, 7]
        return x
    if kind == "times_30":
        return x * np.float32(30.0)
    raise AssertionError(kind)


@pytest.mark.parametrize("impl", ["plain", "split_tf32"])
@pytest.mark.parametrize("kind", ["post_relu", "near_duplicate_rows", "times_30"])
def test_bdc_against_float64(kind, impl):
    """Both float32 routes against the same formula in float64.  A float32
    gram of M = 304 unit-scale products is off by ~1e-4 absolute; where two
    rows nearly coincide, dist2 cancels to ~0 and that error passes through
    sqrt(t * dist2 + 1e-5) at slope t / (2 sqrt(1e-5)) ~ 0.26 (t = 1/608),
    so up to ~1e-4 is expected there (measured: plain 8e-5, split 1.2e-4 over
    three seeds) and ~1e-5 or less elsewhere.  The limit is the 5e-4 the
    port holds against the JAX package."""
    shape = (4, 64, 304)
    x = torch.from_numpy(_adversarial(kind, shape, seed=3))
    log_t = torch.tensor(np.float32(np.log(1.0 / (2 * shape[2]))))
    x64 = x.double()
    truth = bdc_from_gram(x64 @ x64.mT, log_t)
    assert truth.dtype == torch.float64
    ours = (bdc_pool if impl == "plain" else bdc_pool_split_tf32)(x, log_t)
    assert ours.dtype == torch.float32
    assert (ours.double() - truth).abs().max().item() <= ATOL


def test_round_tf32_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32))
    hi = round_tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()  # 10 mantissa bits
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 0.0])
    torch.testing.assert_close(
        round_tf32(tie), torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 0.0]),
        rtol=0, atol=0,
    )
    # hi + tf32(x - hi) keeps 21 bits of x even with lo only truncated:
    # what the three-pass product relies on
    lo = truncate_tf32(x - hi)
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi.double() + lo.double() - x.double()).abs() <= x.abs().double() * 2.0 ** -21).all()


def test_split_tf32_gram_is_as_close_to_float64_as_the_float32_gram():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(4, 64, 304)).astype(np.float32))
    truth = x.double() @ x.double().mT
    err_split = (gram_split_tf32(x).double() - truth).abs().max().item()
    err_fp32 = (torch.matmul(x, x.mT).double() - truth).abs().max().item()
    hi = round_tf32(x)
    err_one_pass = (torch.matmul(hi, hi.mT).double() - truth).abs().max().item()
    # ~2^-22 per product: the same order as fp32 summation, and two orders
    # below a single TF32 pass (2^-11 per operand)
    assert err_split <= 4 * err_fp32 and err_split <= 1e-3
    assert err_one_pass >= 20 * err_split


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
        return torch.zeros((2, 129, 10)), log_t, ValueError, {}
    if case == "float64":
        return x.double(), log_t, TypeError, {}
    if case == "not_contiguous":
        return torch.zeros((2, 10, 64)).transpose(1, 2), log_t, ValueError, {}
    if case == "log_t_size":
        return x, torch.zeros(2), ValueError, {}
    if case == "needs_grad":
        # the triu vector has a backward kernel; the full matrix has none
        return x, torch.zeros((1, 1), requires_grad=True), RuntimeError, {"return_full": True}
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case", ["d_above_limit", "float64", "not_contiguous", "log_t_size", "needs_grad"]
)
def test_kernel_input_checks(case):
    x, log_t, err, kwargs = _kernel_inputs(case)
    with pytest.raises(err):
        bdc_cuda.check_kernel_inputs(x, log_t, **kwargs)


def test_kernel_input_checks_accept_the_supported_range():
    bdc_cuda.check_kernel_inputs(torch.zeros((2, 128, 7)), torch.zeros((1, 1)))
    bdc_cuda.check_kernel_inputs(torch.zeros((1, 1, 1)), torch.zeros(()))
    with torch.no_grad():  # grad-requiring inputs are fine without autograd
        bdc_cuda.check_kernel_inputs(
            torch.zeros((2, 64, 7), requires_grad=True), torch.zeros((1, 1))
        )
    # the triu vector alone has a backward
    bdc_cuda.check_kernel_inputs(torch.zeros((2, 64, 7)),
                                 torch.zeros((1, 1), requires_grad=True))


@pytest.mark.parametrize(
    "shape",
    [(3, 17, 33), (2, 100, 77), (2, 64, 6), (1, 16, 1), (2, 48, 304), (2, 128, 45)],
    ids=lambda s: "x".join(map(str, s)),
)
def test_wrapper_domain_odd_m_and_odd_d(shape):
    """What the kernel's load path distinguishes (M a multiple of 4 or not)
    and what its tiles pad (d a multiple of 16 or not) is all inside the
    wrapper's domain, and the triu order holds at each shape."""
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    log_t = torch.full((1, 1), -2.0)
    bdc_cuda.check_kernel_inputs(x, log_t)
    tri, full = bdc_cuda.bdc_pool_triu(x, log_t, return_full=True)
    d = shape[1]
    assert tri.shape == (shape[0], d * (d + 1) // 2) and full.shape == (shape[0], d, d)
    iu = np.triu_indices(d)
    np.testing.assert_array_equal(tri.numpy(), full.numpy()[:, iu[0], iu[1]])
    np.testing.assert_allclose(bdc_pool_split_tf32(x, log_t).numpy(), full.numpy(), atol=ATOL)


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


def test_build_hashes_the_headers_beside_the_sources(monkeypatch, tmp_path):
    """An edited ``.cuh`` beside a source builds anew (the sources include
    it by relative path), and an unchanged one reuses the library; headers
    elsewhere do not enter."""
    nvcc = _fake_nvcc(tmp_path)
    _isolate_toolkit(monkeypatch, tmp_path, nvcc.parent)
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    src = src_dir / "k.cu"
    src.write_text('#include "common.cuh"\n')
    header = src_dir / "common.cuh"
    header.write_text("// v1\n")
    (tmp_path / "elsewhere.cuh").write_text("// not beside the source\n")
    first = build.build_library("k", [src])
    assert build.build_library("k", [src]) == first
    (tmp_path / "elsewhere.cuh").write_text("// edited\n")
    assert build.build_library("k", [src]) == first
    header.write_text("// v2\n")
    second = build.build_library("k", [src])
    assert second != first and second.is_file()
    assert (tmp_path / "calls").read_text().count("call") == 2


def test_both_kernel_sources_include_the_header_the_build_hashes():
    header = bdc_cuda.SOURCE.with_name("bdc_common.cuh")
    assert header.is_file() and bdc_cuda.BACKWARD_SOURCE.parent == header.parent
    for source in (bdc_cuda.SOURCE, bdc_cuda.BACKWARD_SOURCE):
        assert '#include "bdc_common.cuh"' in source.read_text()


def test_build_extra_flags_make_a_library_of_their_own(monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path)
    _isolate_toolkit(monkeypatch, tmp_path, nvcc.parent)
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    plain = build.build_library("k", [src])
    profiled = build.build_library("k", [src], extra_flags=("-DK_PROFILE",))
    assert profiled != plain and profiled.is_file() and plain.is_file()
    assert build.build_library("k", [src], extra_flags=("-DK_PROFILE",)) == profiled
    assert (tmp_path / "calls").read_text().count("call") == 2


@pytest.mark.parametrize("kernel", ["forward", "backward"])
def test_kernel_source_keeps_its_phase_clocks_out_of_the_default_build(kernel):
    """The phase clocks (and the forward's mma-rate probe) of
    ``profile_bdc_pool`` exist only under ``BDC_POOL_PROFILE``: with the
    macro undefined the source has its launch entries and nothing else
    ``extern "C"``; the profiler reads the shape of the clocks from the
    build that counts them.  The clock macros live in the shared header,
    with empty definitions for the default build."""
    source = bdc_cuda.SOURCE if kernel == "forward" else bdc_cuda.BACKWARD_SOURCE
    prefix = "bdc_pool" if kernel == "forward" else "bdc_pool_backward"
    text = source.read_text()
    assert '#include "bdc_common.cuh"' in text
    default_build, _, profiled = text.rpartition("#ifdef BDC_POOL_PROFILE")
    entries = ({"bdc_pool_launch"} if kernel == "forward"
               else {"bdc_pool_backward_launch", "bdc_pool_backward_cluster",
                     "bdc_pool_backward_sum_log_t"})
    assert default_build.count('extern "C"') == len(entries)
    assert all(f"{e}(" in default_build for e in entries)
    profile_only = [f"{prefix}_phase_shape", f"{prefix}_read_phases"]
    profile_only.append("bdc_pool_mma_rate" if kernel == "forward"
                        else "bdc_pool_backward_launch_cluster")
    for entry in profile_only:
        assert entry in profiled and entry not in default_build
    profiler = (source.parents[1] / "profile_bdc_pool.py").read_text()
    assert f'"{prefix}"' in profiler or f"{prefix}_phase_shape" in profiler
    header = source.with_name("bdc_common.cuh").read_text()
    _, _, default_macros = header.partition("#else\n")
    assert "#define PHASE_END(k)\n" in default_macros  # the empty definition
    assert "#define PHASE_CLOCKS(n)\n" in default_macros


def test_build_failure_leaves_no_library(monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path, exit_code=2)
    _isolate_toolkit(monkeypatch, tmp_path, nvcc.parent)
    src = tmp_path / "k.cu"
    src.write_text("// broken\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build_library("k", [src])
    assert not list((tmp_path / "kernels").glob("*.so*"))
