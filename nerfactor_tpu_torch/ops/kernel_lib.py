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


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C entry points' argument types (every one returns an int error code)
ARGTYPES = {
    'nfk_chain_fwd': [_PTR, _I32, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _I64,
                      _PTR],
    'nfk_rusink_chain_fwd': [_PTR, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                             _I64, _PTR],
    'nfk_chain_bwd_slices': [_PTR, _I32, _I32, _I64, _PTR],
    'nfk_chain_bwd': [_PTR, _I32, _I32, _I32, _I32, _PTR, _PTR, _PTR, _PTR,
                      _PTR, _PTR, _PTR, _PTR, _I32, _I64, _PTR],
    'nfk_chain_tc_runs': [_PTR, _I32, _PTR],
    'nfk_chain_fwd_tc': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _PTR],
    'nfk_chain_f32_tc_runs': [_PTR, _I32, _PTR],
    'nfk_chain_fwd_tc_f32': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I64,
                             _PTR],
    'nfk_chain_bwd_dx_tc_f32': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                _I32, _I64, _PTR],
    'nfk_chain_bwd_dw_tc_f32_sizes': [_PTR, _I64, _PTR, _PTR, _PTR, _PTR],
    'nfk_chain_bwd_dw_tc_f32': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                _PTR, _PTR, _I32, _I32, _I32, _I64, _PTR],
    'nfk_pack_transposed': [_PTR, _I32, _PTR, _PTR, _PTR],
    'nfk_pack_transposed_table': [_PTR, _I32, _PTR, _PTR, _PTR],
    'nfk_chain_stash_fwd_tc': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64,
                               _PTR],
    'nfk_chain_last_skip_fwd_tc': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64,
                                   _PTR],
    'nfk_chain_bwd_tc_sizes': [_PTR, _I64, _PTR, _PTR, _PTR, _PTR],
    'nfk_chain_bwd_tc': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                         _PTR, _I32, _I32, _I64, _PTR],
    'nfk_chain_stash_bwd_tc': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                               _PTR, _PTR, _I32, _I32, _I64, _PTR],
    'nfk_chain_last_skip_bwd_tc': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                   _PTR, _PTR, _PTR, _I32, _I32, _I64, _PTR],
    'nfk_chain_dw_table': [_PTR, _PTR, _PTR],
    'nfk_dw_pass': [_PTR, _I32, _PTR, _PTR, _PTR, _I64, _PTR],
    'nfk_rusink_chain_bwd': [_PTR, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                             _PTR, _PTR, _PTR, _I64, _PTR],
    'nfk_rusink_chain_tc_runs': [_PTR, _PTR],
    'nfk_rusink_chain_fwd_tc': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                _PTR, _I64, _PTR],
    'nfk_rusink_chain_bwd_tc': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                _PTR, _PTR, _PTR, _PTR, _I64, _PTR],
    'nfk_nerf_fwd': [_PTR, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64,
                     _PTR],
    'nfk_nerf_fwd_tc': [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64,
                        _PTR],
    'nfk_nerf_bwd_sizes': [_PTR, _I32, _I64, _PTR, _PTR, _PTR, _PTR],
    'nfk_nerf_bwd': [_PTR, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                     _PTR, _PTR, _PTR, _I32, _I32, _I64, _PTR],
    'nfk_nerf_dw_table': [_PTR, _PTR, _PTR],
    'nfk_tc_matmul': [_PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR],
    'nfk_tc_matmul_f32': [_PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _PTR],
    'nfk_dot_chain': [_I32, _PTR, _PTR, _I32, _I64, _I64, _PTR, _PTR, _PTR],
    'nfk_dot_chain_mma': [_I32, _PTR, _PTR, _I32, _I64, _I64, _PTR, _PTR],
    'nfk_wgmma_tile': [_PTR, _PTR, _I32, _I32, _I32, _PTR, _PTR],
    'nfk_dot_chain_plan': [_I32, _PTR, _PTR, _PTR],
}


def load():
    """Builds (if needed) and loads the kernel library, once per
    process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.nfk_error_string.argtypes = [_I32]
        lib.nfk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def entry(name):
    """The library's C function ``name``, bound to its ARGTYPES on first
    use. Binding by name keeps a library that lacks an entry loadable: the
    CPU emulation of the sources leaves out ``dot_probe_mma.cu`` (kernel
    P's ``mma.sync`` control, whose inline assembly needs the card), and an
    older tree's sources lack later entries."""
    fn = getattr(load(), name)
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES[name]
        fn.restype = _I32
    return fn


def check(code, what):
    """Raises if a launcher returned a non-zero error code."""
    if code != 0:
        msg = _lib.nfk_error_string(code).decode()
        raise RuntimeError("%s failed: %s (code %d)" % (what, msg, code))


# Every wrapper's launch counters, (function, attribute) pairs, registered
# where the wrapper is defined. A CUDA graph's capture launches nothing and
# each of its replays launches every kernel it holds: make_train_step_scan
# (parallel/train.py) takes back what its capture counted and adds that at
# each replay, so the counters count what the card runs.
COUNTERS = []


def launch_counters(fn, *attrs):
    """Registers ``fn.<attr>`` for each of ``attrs`` as a launch counter,
    set to 0."""
    for attr in attrs:
        setattr(fn, attr, 0)
        COUNTERS.append((fn, attr))


def launch_counts():
    """{(function, attribute): count} of every registered counter."""
    return {(fn, attr): getattr(fn, attr) for fn, attr in COUNTERS}


def add_launches(deltas):
    """Adds each of ``deltas`` ({(function, attribute): launches}) to its
    counter."""
    for (fn, attr), n in deltas.items():
        setattr(fn, attr, getattr(fn, attr) + n)
