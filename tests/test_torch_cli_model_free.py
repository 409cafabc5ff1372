"""The port's command line serving the model-free engines, against the JAX
CLI.

``python -m dynamo_tpu_torch run in=http|text|batch|dyn out=mocker|echo``
serves what ``python -m dynamo_tpu run`` serves for the same pair, on the
same tokenizer directory (the ``model_dir`` fixture: no weights):

* ``in=http``: a completion's text, and ``/v1/embeddings`` vectors
  (the mocker's ``embed``; ``fake_embedder`` for the echo engine);
* ``in=text``: the printed reply; ``in=batch``: the JSONL results;
* ``in=dyn out=mocker``: a port worker owning the hub beside a JAX
  worker, behind the port's and the JAX KV-routed front ends -- every
  completion equals the JAX CLI's ``in=http out=mocker`` text, and both
  front ends list the model;
* ``in=dyn out=echo``: a port worker behind the port's round-robin front
  end.  The JAX CLI's echo worker exits on start (its echo engine has no
  load metrics), so its text is held to the JAX CLI's ``in=http``.

Every process is bounded by a deadline and killed on the way out.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 90
PROMPT = "hello world"
CHAT = "tell me a story"
EMBED_INPUTS = ["hello world", "the quick brown fox"]
MAX_TOKENS = 8
ENGINES = ("mocker", "echo")


class Proc:
    """One CLI process, its stdout lines read on a thread (so a wait has a
    deadline), its stderr kept in a file for the failure message."""

    def __init__(self, pkg: str, *argv: str, tmp) -> None:
        self.err = open(tmp / f"err-{pkg}-{time.monotonic_ns()}.log", "w+")
        self.p = subprocess.Popen(
            [sys.executable, "-m", pkg, *argv], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=self.err, text=True,
            env={**os.environ, "DYN_LOG": "warning", "PYTHONUNBUFFERED": "1",
                 "JAX_PLATFORMS": "cpu"},
        )
        self.lines: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.p.stdout:
            self.lines.put(line)
        self.lines.put("")

    def stderr(self) -> str:
        self.err.seek(0)
        return self.err.read()[-3000:]

    def expect(self, prefix: str) -> str:
        deadline = time.monotonic() + WAIT_S
        while True:
            try:
                line = self.lines.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise AssertionError(f"no {prefix!r} line: {self.stderr()}")
            assert line, f"exited before {prefix!r}: {self.stderr()}"
            if line.startswith(prefix):
                return line.strip()

    def output(self) -> str:
        """Everything the process prints, once it has exited."""
        self.p.wait(timeout=WAIT_S)
        out = []
        while True:
            line = self.lines.get(timeout=WAIT_S)
            if not line:
                return "".join(out)
            out.append(line)

    def stop(self) -> None:
        if self.p.poll() is None:
            self.p.send_signal(signal.SIGINT)
            try:
                self.p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait(timeout=30)
        self.err.close()


def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
        return json.loads(resp.read())


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=WAIT_S) as resp:
        return json.loads(resp.read())


def base_url(banner: str) -> str:
    return next(w for w in banner.split() if w.startswith("http://"))


def ask(base: str, name: str, embed: bool = True) -> dict:
    out = {"text": post(f"{base}/v1/completions", {
        "model": name, "prompt": PROMPT, "max_tokens": MAX_TOKENS, "temperature": 0.0,
    })["choices"][0]["text"]}
    if embed:
        body = post(f"{base}/v1/embeddings", {"model": name, "input": EMBED_INPUTS})
        out["embeddings"] = [d["embedding"] for d in body["data"]]
    return out


def wait_for_model(base: str, name: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while name not in [m["id"] for m in get(f"{base}/v1/models")["data"]]:
        assert time.monotonic() < deadline, f"{name} never discovered at {base}"
        time.sleep(0.1)


def serve_http(pkg: str, engine: str, model_dir: str, tmp) -> dict:
    proc = Proc(pkg, "run", "in=http", f"out={engine}", "--model-path", model_dir,
                "--model-name", "m", "--port", "0", tmp=tmp)
    try:
        return ask(base_url(proc.expect("serving m at ")), "m")
    finally:
        proc.stop()


def run_text(pkg: str, engine: str, model_dir: str, tmp) -> str:
    proc = Proc(pkg, "run", "in=text", f"out={engine}", "--model-path", model_dir,
                "--prompt", CHAT, "--max-tokens", str(MAX_TOKENS), tmp=tmp)
    try:
        out = proc.output()
        assert proc.p.returncode == 0, proc.stderr()
        return out
    finally:
        proc.stop()


def run_batch(pkg: str, engine: str, model_dir: str, tmp) -> list:
    src = tmp / f"prompts-{pkg}-{engine}.jsonl"
    dst = tmp / f"results-{pkg}-{engine}.jsonl"
    src.write_text("".join(json.dumps({"text": t, "max_tokens": MAX_TOKENS}) + "\n"
                           for t in (CHAT, PROMPT)))
    proc = Proc(pkg, "run", "in=batch", f"out={engine}", "--model-path", model_dir,
                "--input-file", str(src), "--output-file", str(dst), tmp=tmp)
    try:
        proc.output()
        assert proc.p.returncode == 0, proc.stderr()
        return [json.loads(line) for line in dst.read_text().splitlines()]
    finally:
        proc.stop()


MODES = {"http": serve_http, "text": run_text, "batch": run_batch}


@pytest.fixture(scope="module")
def jax_cli(model_dir, tmp_path_factory):
    """The JAX CLI's answers for every (in, out) pair it serves, its
    processes run side by side."""
    tmp = tmp_path_factory.mktemp("jax-cli")
    out, errors = {}, []

    def one(inp, engine):
        try:
            out[inp, engine] = MODES[inp]("dynamo_tpu", engine, model_dir, tmp)
        except BaseException as e:  # surfaced below, with its pair
            errors.append((inp, engine, e))

    threads = [threading.Thread(target=one, args=(inp, eng)) for inp in MODES for eng in ENGINES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=4 * WAIT_S)
    assert not any(t.is_alive() for t in threads), "a CLI pair outlived its bound"
    assert not errors, errors
    return out


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("inp", list(MODES))
def test_cli_serves_model_free_engine_like_jax(jax_cli, model_dir, tmp_path, inp, engine):
    got = MODES[inp]("dynamo_tpu_torch", engine, model_dir, tmp_path)
    want = jax_cli[inp, engine]
    assert got == want
    if inp == "http":
        assert got["text"] and len(got["embeddings"]) == 2
    elif inp == "batch":
        assert [r["index"] for r in got] == [0, 1] and all(r["response"] for r in got)
    else:
        assert got.strip()


def test_cli_serves_mocker_workers_of_both_packages(jax_cli, model_dir, tmp_path):
    """``in=dyn out=mocker``: a port worker (its hub in process) and a JAX
    worker on one hub, each front end KV-routed: every answer is the JAX
    CLI's ``in=http out=mocker`` answer."""
    procs = []
    try:
        port_worker = Proc("dynamo_tpu_torch", "run", "in=dyn", "out=mocker", "--hub", "auto",
                           "--model-path", model_dir, "--model-name", "m", tmp=tmp_path)
        procs.append(port_worker)
        banner = port_worker.expect("worker serving model m on ")
        hub = banner.rsplit("(hub ", 1)[1].rstrip(")")
        procs.append(Proc("dynamo_tpu", "run", "in=dyn", "out=mocker", "--hub", hub,
                          "--model-path", model_dir, "--model-name", "m", tmp=tmp_path))
        procs[-1].expect("worker serving model m on ")
        fronts = []
        for pkg in ("dynamo_tpu_torch", "dynamo_tpu"):
            procs.append(Proc(pkg, "run", "in=http", "out=dyn", "--hub", hub,
                              "--router-mode", "kv", "--port", "0", tmp=tmp_path))
            fronts.append(base_url(procs[-1].expect("frontend at ")))
        want = jax_cli["http", "mocker"]
        for base in fronts:
            wait_for_model(base, "m")
            for _ in range(3):
                assert ask(base, "m") == want
    finally:
        for p in reversed(procs):
            p.stop()


def test_cli_serves_an_echo_worker(jax_cli, model_dir, tmp_path):
    """``in=dyn out=echo`` behind the port's front end answers the JAX
    CLI's ``in=http out=echo`` text (no embed leg, no load metrics: a
    round-robin front end)."""
    procs = []
    try:
        worker = Proc("dynamo_tpu_torch", "run", "in=dyn", "out=echo", "--hub", "auto",
                      "--model-path", model_dir, "--model-name", "m", tmp=tmp_path)
        procs.append(worker)
        hub = worker.expect("worker serving model m on ").rsplit("(hub ", 1)[1].rstrip(")")
        procs.append(Proc("dynamo_tpu_torch", "run", "in=http", "out=dyn", "--hub", hub,
                          "--port", "0", tmp=tmp_path))
        base = base_url(procs[-1].expect("frontend at "))
        wait_for_model(base, "m")
        assert ask(base, "m", embed=False)["text"] == jax_cli["http", "echo"]["text"]
    finally:
        for p in reversed(procs):
            p.stop()
