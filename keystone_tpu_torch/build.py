"""Builds the port's CUDA kernels and its native host library at first use.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``_build/`` and loaded
with ``ctypes``. The library's file name carries a digest of its source and
flags, so an edited source is rebuilt, never served stale. ``build()``
starts one ``nvcc`` per source, all together, and waits for all of them.

``native_library()`` builds the host library of ``csrc/native/`` (dense
SIFT, GMM EM, Fisher vectors and the libjpeg decode pool) with ``g++`` and
the flags of ``keystone_tpu/native/Makefile``: one compiler per source, all
together, then one link. As the Makefile does, it adds ``jpeg_pool.cpp``
and ``-ljpeg`` only where ``jpeg_probe.cpp`` links with ``-ljpeg`` (an
answer kept in ``_build/`` for each host). The library is named by a digest
of its sources, flags, that answer and the host's compiler and target.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fisher_vector",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# What ptxas said about each library built in this process (registers,
# shared memory, spills), by source name.
BUILD_LOGS: dict = {}
_libraries: dict = {}
# Held while a library is built and loaded: two threads that reach a kernel
# at once (the executor's parallel walk) build it once.
_library_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compiles every named source whose library is missing, in parallel.
    Returns the wall seconds of each build (0.0 where the library was
    already there); raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


NATIVE_SRC = CSRC / "native"
NATIVE_SOURCES = ("sift", "gmm_fv")
NATIVE_JPEG_SOURCE = "jpeg_pool"
NATIVE_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp", "-Wall", "-Wextra")
NATIVE_LDFLAGS = ("-shared", "-fopenmp")
# What the last native build in this process did: wall seconds (0.0 when
# the library was already built) and whether the decode pool is in it.
NATIVE_BUILD: dict = {}


def cxx() -> str:
    """``g++`` on PATH. ``CXX`` is not read: a host may point it at a
    compiler that cannot link OpenMP, which the library needs."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("no C++ compiler: put g++ on PATH")
    return found


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def native_host(compiler: str) -> str:
    """A digest of the compiler and of the target ``-march=native`` selects
    on this host, as ``g++ -Q --help=target`` reports it: a library built
    on one host is never loaded on a host whose processor differs."""
    query = subprocess.run([compiler, "-march=native", "-Q", "--help=target"],
                           capture_output=True, text=True)
    if query.returncode != 0:
        raise RuntimeError(f"{compiler} -march=native -Q --help=target failed (rc {query.returncode}):\n"
                           f"{query.stdout}{query.stderr}")
    return hashlib.sha256(f"{compiler}\n{query.stdout}".encode()).hexdigest()[:16]


def native_has_jpeg(compiler: str, host: str) -> bool:
    """Whether ``jpeg_probe.cpp`` compiles and links with ``-ljpeg`` here.
    The answer is kept in ``_build/`` by host, so the probe runs once."""
    marker = BUILD_DIR / f"native-jpeg-{host}.txt"
    if marker.exists():
        return marker.read_text().strip() == "1"
    probe = _run([compiler, str(NATIVE_SRC / "jpeg_probe.cpp"), "-ljpeg", "-o", os.devnull])
    probe.communicate()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = marker.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text("1" if probe.returncode == 0 else "0")
    os.replace(tmp, marker)
    return probe.returncode == 0


def native_library_path(sources, jpeg: bool, host: str) -> Path:
    digest = hashlib.sha256()
    for name in (*sources, "keystone_native.h"):
        path = NATIVE_SRC / (name if name.endswith(".h") else f"{name}.cpp")
        digest.update(path.read_bytes())
    digest.update(" ".join((*NATIVE_CXXFLAGS, *NATIVE_LDFLAGS, str(jpeg), host)).encode())
    return BUILD_DIR / f"libkeystone_native-{digest.hexdigest()[:16]}.so"


def native_library() -> tuple:
    """(path, has_jpeg) of the host library, built first if missing; raises
    with the compiler's output if a build fails."""
    compiler = cxx()
    host = native_host(compiler)
    jpeg = native_has_jpeg(compiler, host)
    sources = (*NATIVE_SOURCES, NATIVE_JPEG_SOURCE) if jpeg else NATIVE_SOURCES
    out = native_library_path(sources, jpeg, host)
    if out.exists():
        NATIVE_BUILD.update(seconds=0.0, jpeg=jpeg)
        return out, jpeg
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp_dir = BUILD_DIR / f"native.{os.getpid()}.tmp"
    tmp_dir.mkdir(exist_ok=True)
    try:
        objects = {name: tmp_dir / f"{name}.o" for name in sources}
        procs = {
            name: _run([compiler, *NATIVE_CXXFLAGS, "-c", str(NATIVE_SRC / f"{name}.cpp"), "-o", str(obj)])
            for name, obj in objects.items()
        }
        failures = []
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{compiler} failed for {name}.cpp (rc {proc.returncode}):\n{log}")
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = tmp_dir / out.name
        link = _run([compiler, *NATIVE_LDFLAGS, "-o", str(tmp), *map(str, objects.values()),
                     *(["-ljpeg"] if jpeg else [])])
        log, _ = link.communicate()
        if link.returncode != 0:
            raise RuntimeError(f"{compiler} failed to link {out.name} (rc {link.returncode}):\n{log}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    NATIVE_BUILD.update(seconds=time.perf_counter() - t0, jpeg=jpeg)
    return out, jpeg


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libraries.get(name)
    if lib is None:
        with _library_lock:
            lib = _libraries.get(name)
            if lib is None:
                build((name,))
                lib = ctypes.CDLL(str(library_path(name)))
                _libraries[name] = lib
    return lib
