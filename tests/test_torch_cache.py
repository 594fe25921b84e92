"""The kernels' build cache (pbccs_tpu_torch/runtime/cache.py) and
`--compileCache DIR` on `ccs serve`, `ccs warmup` and `ccs fleet`, on the
CPU (where nothing is built: the directory is resolved and handed on).

Directory resolution: the flag first, then build/kernels/ of a writable
source tree, then ~/.cache/pbccs_tpu_torch/kernels.  Library names: a
hash over the kernel's source, the shared headers and NVCC_FLAGS, so a
change to any of them gives a new name.  The flag parses on the three
subcommands, warmup and serve point the builds at it, and the fleet
forwards it to its replicas' argv."""

import json
import os
import shutil
import subprocess
import sys
import threading

import pytest

from pbccs_tpu_torch.ops import cuda_lib
from pbccs_tpu_torch.runtime import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir(monkeypatch):
    """Put the process's build-cache choice back after the test."""
    monkeypatch.setattr(cache, "_cache_dir", cache._cache_dir)


def _tree(root, gitignore=True):
    root.mkdir(parents=True, exist_ok=True)
    if gitignore:
        (root / ".gitignore").write_text("build/\n")
    return root


def test_flag_first(tmp_path, monkeypatch, restore_cache_dir):
    monkeypatch.setattr(cache, "_REPO", str(_tree(tmp_path / "repo")))
    got = cache.enable_compilation_cache(str(tmp_path / "d"))
    assert got == str(tmp_path / "d") == cache.cache_dir()
    monkeypatch.chdir(tmp_path)
    assert cache.enable_compilation_cache("rel") == str(tmp_path / "rel")


def test_checkout_build_dir_when_writable(tmp_path, monkeypatch,
                                          restore_cache_dir):
    repo = _tree(tmp_path / "repo")
    monkeypatch.setattr(cache, "_REPO", str(repo))
    want = str(repo / "build" / "kernels")
    assert cache.default_cache_dir() == want
    assert cache.enable_compilation_cache() == want == cache.cache_dir()
    (repo / "build" / "kernels").mkdir(parents=True)
    assert cache.default_cache_dir() == want


def test_read_only_checkout_falls_back_to_home(tmp_path, monkeypatch):
    repo = _tree(tmp_path / "repo")
    monkeypatch.setattr(cache, "_REPO", str(repo))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    probed = []

    def access(path, mode):
        probed.append(path)
        return False

    monkeypatch.setattr(cache.os, "access", access)
    assert cache.default_cache_dir() == str(
        tmp_path / "home" / ".cache" / "pbccs_tpu_torch" / "kernels")
    # the nearest existing directory of build/kernels/ is what is probed
    assert probed == [str(repo)]


def test_not_a_source_tree_falls_back_to_home(tmp_path, monkeypatch,
                                              restore_cache_dir):
    """An installed package (no .gitignore beside it) builds under the
    user's cache directory, not beside the package."""
    monkeypatch.setattr(cache, "_REPO",
                        str(_tree(tmp_path / "site", gitignore=False)))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    want = str(tmp_path / "home" / ".cache" / "pbccs_tpu_torch" / "kernels")
    assert cache.default_cache_dir() == want
    assert cache.enable_compilation_cache(None) == want


def test_this_checkout_builds_under_build_kernels():
    """`python3 chip_smoke.py` from a checkout: build/kernels/."""
    assert cache.default_cache_dir() == os.path.join(REPO, "build",
                                                     "kernels")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch, restore_cache_dir):
    """cuda_lib reading a copy of csrc/ and building into tmp/d."""
    src = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, src)
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", str(src))
    cache.enable_compilation_cache(str(tmp_path / "d"))
    return src


@pytest.mark.parametrize("name", cuda_lib.KERNELS)
def test_library_name_hashes_sources_headers_and_flags(csrc_copy,
                                                        monkeypatch, name):
    first = cuda_lib.lib_path(name)
    assert os.path.dirname(first) == cache.cache_dir()
    base = os.path.basename(first)
    assert base.startswith(f"lib{name}-") and base.endswith(".so")
    assert cuda_lib.lib_path(name) == first           # deterministic
    names = {first}
    with open(csrc_copy / f"{name}.cu", "a") as fh:
        fh.write("\n// edited\n")
    names.add(cuda_lib.lib_path(name))
    (header,) = [p for p in sorted(os.listdir(csrc_copy))
                 if p.endswith(".cuh")][:1]
    with open(csrc_copy / header, "a") as fh:
        fh.write("\n// edited\n")
    names.add(cuda_lib.lib_path(name))
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS",
                        [*cuda_lib.NVCC_FLAGS, "-lineinfo"])
    names.add(cuda_lib.lib_path(name))
    assert len(names) == 4
    # another kernel's source does not enter this kernel's name
    other = next(k for k in cuda_lib.KERNELS if k != name)
    before = cuda_lib.lib_path(name)
    with open(csrc_copy / f"{other}.cu", "a") as fh:
        fh.write("\n// edited\n")
    assert cuda_lib.lib_path(name) == before


def test_build_counts_hits_and_publishes_atomically(csrc_copy, tmp_path,
                                                    monkeypatch):
    """With nvcc stubbed by a script that copies its source: the first
    load builds into the cache directory (a miss and one compile), a
    later load with the process's handles dropped (as a fresh process
    sees it) is a hit with no compile, and nothing is left under a temp
    name."""
    from pbccs_tpu_torch.obs.metrics import default_registry

    # the stub takes `... -o OUT SRC` and copies SRC to OUT; ctypes is
    # kept out of the test (load returns the path it would open)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "while [ \"$1\" != \"-o\" ]; do shift; done\n"
                    "cp \"$3\" \"$2\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_lib, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(cuda_lib, "_libs", {})
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", lambda path: path)
    scope = default_registry().scope()
    assert cuda_lib.load("arrow_fill") == cuda_lib.lib_path("arrow_fill")
    monkeypatch.setattr(cuda_lib, "_libs", {})
    assert cuda_lib.load("arrow_fill") == cuda_lib.lib_path("arrow_fill")
    assert scope.counter_value("ccs_compiles_total") == 1
    assert scope.counter_value("ccs_compile_cache_events_total",
                               kind="miss") == 1
    assert scope.counter_value("ccs_compile_cache_events_total",
                               kind="hit") == 1
    assert os.listdir(cache.cache_dir()) == [
        os.path.basename(cuda_lib.lib_path("arrow_fill"))]
    with open(cuda_lib.lib_path("arrow_fill")) as fh:
        assert fh.read() == (csrc_copy / "arrow_fill.cu").read_text()


# ------------------------------------------------------------ the flag

@pytest.mark.parametrize("sub", ["serve", "warmup", "fleet"])
def test_flag_parses_on_serve_warmup_and_fleet(sub):
    from pbccs_tpu_torch.sched.warmup import build_parser
    from pbccs_tpu_torch.serve.server import build_serve_parser
    from pbccs_tpu_torch.serve.supervisor import build_fleet_parser

    parser = {"serve": build_serve_parser, "warmup": build_parser,
              "fleet": build_fleet_parser}[sub]()
    assert parser.parse_args([]).compileCache is None
    assert parser.parse_args(["--compileCache", "d"]).compileCache == "d"


def test_warmup_points_the_builds_at_the_flag(tmp_path, capsys,
                                              restore_cache_dir):
    from pbccs_tpu_torch.cli import run

    d = tmp_path / "kcache"
    assert run(["warmup", "--compileCache", str(d), "--bucket", "2x3x40",
                "--logLevel", "WARN"], device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["compile_cache"] == str(d) == cache.cache_dir()
    assert [e["bucket"] for e in out["warmed"]] == ["2x3x40"]
    assert "kernels" not in out       # nothing to build on the CPU


SERVE_CHILD = ("import sys\n"
               "from pbccs_tpu_torch.runtime import cache\n"
               "from pbccs_tpu_torch.serve.server import run_serve\n"
               "rc = run_serve(sys.argv[1:], device='cpu')\n"
               "print('CACHE', cache.cache_dir(), flush=True)\n"
               "sys.exit(rc)\n")


def test_serve_points_the_builds_at_the_flag(tmp_path):
    """A `ccs serve --compileCache DIR` process comes up, drains on
    SIGTERM, and its builds pointed at DIR."""
    d = tmp_path / "kcache"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_CHILD, "--port", "0",
         "--compileCache", str(d), "--logLevel", "ERROR"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    # a child silent past the bound is killed: its stdout ends, and the
    # readline loop with it
    watchdog = threading.Timer(120.0, proc.kill)
    watchdog.start()
    try:
        line = proc.stdout.readline()
        while line and not line.startswith("CCS-SERVE-READY"):
            line = proc.stdout.readline()
        watchdog.cancel()
        assert line.startswith("CCS-SERVE-READY"), line
        proc.send_signal(15)
        out, _ = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0
    assert f"CACHE {d}" in out


def test_fleet_forwards_the_flag_to_every_replica(monkeypatch):
    """Every `ccs serve` child the fleet spawns gets `--compileCache
    DIR` in its argv."""
    from pbccs_tpu_torch.serve import supervisor

    args = supervisor.build_fleet_parser().parse_args(
        ["--compileCache", "/shared/kernels", "--serveArg=--maxBatch=4"])
    tail = supervisor.child_serve_args(args)
    assert tail[tail.index("--compileCache") + 1] == "/shared/kernels"
    seen = []

    def popen(cmd, **kw):
        seen.append(cmd)
        raise OSError("not spawned here")

    monkeypatch.setattr(supervisor.subprocess, "Popen", popen)
    spawn = supervisor.make_serve_spawn(tail, ready_timeout_s=5.0,
                                        device="cpu")
    for slot in (0, 1):
        with pytest.raises(supervisor.SpawnError):
            spawn(slot, 0)
    assert len(seen) == 2
    for cmd in seen:
        i = cmd.index("--compileCache")
        assert cmd[i + 1] == "/shared/kernels"
        assert cmd[-1] == "--maxBatch=4"
