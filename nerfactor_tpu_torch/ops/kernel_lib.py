"""Builds and loads the package's CUDA kernels.

The sources in ``nerfactor_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for Hopper (``sm_90a``) into one shared library with a
plain C interface, which is bound through ``ctypes``. The library lands
in ``build/kernels-<hash>/`` at the repository root, keyed on a hash of
the sources and the compiler flags, so a fresh checkout builds it once
and an edited source builds anew.

Nothing here runs at import: :func:`load` builds on its first call.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from os.path import abspath, dirname, exists, join

PKG_DIR = dirname(dirname(abspath(__file__)))
CSRC_DIR = join(PKG_DIR, 'csrc')
BUILD_ROOT = join(dirname(PKG_DIR), 'build')
# No --use_fast_math: posenc reaches sin(2^9 x), where __sinf is too coarse
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
LINK_FLAGS = ('-shared',)
LIB_NAME = 'libnfk.so'

_lib = None


def _sources():
    names = sorted(f for f in os.listdir(CSRC_DIR)
                   if f.endswith(('.cu', '.cuh')))
    return [join(CSRC_DIR, f) for f in names]


def build_key():
    """Hash of the kernel sources and the compiler flags."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc():
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    which = shutil.which('nvcc')
    if which:
        candidates.append(which)
    candidates.append('/usr/local/cuda/bin/nvcc')
    for path in candidates:
        if exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def build():
    """Compiles the kernels if this source hash has no library yet;
    returns the library path. Each ``.cu`` compiles in its own ``nvcc``,
    all at once, and one more links them. The compiler's
    register/shared-memory report is kept beside the library as
    ``build.log``."""
    out_dir = join(BUILD_ROOT, 'kernels-' + build_key())
    lib_path = join(out_dir, LIB_NAME)
    if exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc, tag = find_nvcc(), '.tmp%d' % os.getpid()
    objs, cmds = [], []
    for src in (p for p in _sources() if p.endswith('.cu')):
        obj = join(out_dir, '%s%s.o' % (os.path.basename(src)[:-3], tag))
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, '-c', '-o', obj, src])
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = [' '.join(cmd) + '\n' + out for cmd, out in zip(cmds, outs)]
    failed = [out for p, out in zip(procs, outs) if p.returncode != 0]
    if not failed:
        link = [nvcc, *LINK_FLAGS, '-o', lib_path + tag, *objs]
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, check=False)
        log.append(' '.join(link) + '\n' + proc.stdout)
        if proc.returncode != 0:
            failed.append(proc.stdout)
    with open(join(out_dir, 'build.log'), 'w') as f:
        f.write('\n'.join(log))
    for obj in objs:
        if exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n%s" % '\n'.join(failed)[-8000:])
    os.replace(lib_path + tag, lib_path)
    return lib_path


def load():
    """Builds (if needed) and loads the kernel library, once per
    process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nfk_error_string.argtypes = [i32]
    lib.nfk_error_string.restype = ctypes.c_char_p
    lib.nfk_chain_fwd.argtypes = [ptr, i32, i32, ptr, ptr, ptr, ptr, ptr, i64,
                                  ptr]
    lib.nfk_chain_fwd.restype = i32
    lib.nfk_rusink_chain_fwd.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr]
    lib.nfk_rusink_chain_fwd.restype = i32
    lib.nfk_chain_bwd_slices.argtypes = [ptr, i32, i32, i64, ptr]
    lib.nfk_chain_bwd_slices.restype = i32
    lib.nfk_chain_bwd.argtypes = [
        ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
        i64, ptr]
    lib.nfk_chain_bwd.restype = i32
    lib.nfk_rusink_chain_bwd.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr]
    lib.nfk_rusink_chain_bwd.restype = i32
    lib.nfk_nerf_fwd.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr]
    lib.nfk_nerf_fwd.restype = i32
    lib.nfk_nerf_bwd_sizes.argtypes = [ptr, i32, i64, ptr, ptr, ptr, ptr]
    lib.nfk_nerf_bwd_sizes.restype = i32
    lib.nfk_nerf_bwd.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
        i64, ptr]
    lib.nfk_nerf_bwd.restype = i32
    lib.nfk_nerf_dw.argtypes = [ptr, ptr, ptr, ptr, i32, i64, ptr]
    lib.nfk_nerf_dw.restype = i32
    lib.nfk_tc_matmul.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.nfk_tc_matmul.restype = i32
    _lib = lib
    return lib


def dot_chain_entry():
    """The library's ``nfk_dot_chain`` (kernel P), bound on first use: the
    CPU emulation of the sources leaves out ``dot_probe.cu`` (its inline
    ``mma.sync`` assembly needs the card), so :func:`load` binds only what
    every build of the library has."""
    fn = load().nfk_dot_chain
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i32, ptr, ptr, i32, i64, i64, ptr, ptr]
        fn.restype = i32
    return fn


def check(code, what):
    """Raises if a launcher returned a non-zero error code."""
    if code != 0:
        msg = _lib.nfk_error_string(code).decode()
        raise RuntimeError("%s failed: %s (code %d)" % (what, msg, code))
