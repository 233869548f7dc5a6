"""Worker-backed vectorized envs (port of ``habitat_tpu/core/vector_env.py``;
reference habitat-lab/habitat/core/vector_env.py).

- ``VectorEnv`` runs one env per worker PROCESS (``forkserver`` by default:
  a forked child of a process that holds a CUDA context cannot use the
  card) and speaks (command, data) tuples over pipes, one outstanding
  message per worker.
- ``ThreadedVectorEnv`` runs the same worker loop in threads of this
  process (nothing is pickled, so ``make_env_fn`` may be a closure); the
  workers share the process's CUDA context and its default stream.

Commands: step, reset, render, close, call, count_episodes. A step of a
gym-style env (a 4-tuple) whose episode is done, or of an ``Env`` whose
``episode_over`` is set, resets the env before the reply
(``auto_reset_done``). The constructor asks each worker for its env's
``observation_shapes``, ``action_names`` and ``number_of_episodes``, the
port's counterparts of the gymnasium spaces.

What crosses the pipe: host copies. A process worker moves every tensor of
a reply to the host and pickles it with the standard pickler (not torch's
``ForkingPickler`` reductions, which would send a CUDA tensor as an IPC
handle whose owner must outlive every reader, and a CPU tensor through
shared memory); the parent puts tensors on its own ``device``. The threaded
variant hands over the objects themselves, moved to ``device``. Either way
the results equal those of the same env stepped in this process.

Worker errors are forwarded: a worker whose ``make_env_fn`` or command
raises sends the traceback as text and ends, and the parent raises
``RuntimeError`` naming the worker's index and the command. A worker process
that ends without a reply (a kill, a CUDA fault) raises the same way with
its exit code; the parent polls and never blocks on a dead worker.
``close()`` returns after such an error, and terminates a process that does
not end within its deadline.

Before it starts workers, the parent builds the native helper and, when its
device is a card, the kernel libraries (``cuda_build.ensure_built``), so N
workers do not each run the compilers.
"""

from __future__ import annotations

import atexit
import multiprocessing
import pickle
import queue as _queue
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from habitat_torch.device import resolve_device

STEP_COMMAND = "step"
RESET_COMMAND = "reset"
RENDER_COMMAND = "render"
CLOSE_COMMAND = "close"
CALL_COMMAND = "call"
COUNT_EPISODES_COMMAND = "count_episodes"
MAKE_ENV_COMMAND = "make_env_fn"  # the name a failed env construction is reported under

_POLL_S = 0.05  # how often the parent checks that a silent worker is alive
_CLOSE_TIMEOUT_S = 30.0
# vector envs still open: closed at exit, before worker threads are frozen
_OPEN: "weakref.WeakSet[VectorEnv]" = weakref.WeakSet()


@atexit.register
def _close_open() -> None:
    for envs in list(_OPEN):
        envs.close()


class _WorkerError:
    """A worker's exception: the command it ran and the traceback text."""

    def __init__(self, command: str, text: str):
        self.command, self.text = command, text


def _map(x, fn):
    """``fn`` applied to every leaf of nested dicts, lists and tuples (dict
    subclasses such as ``Metrics`` keep their type)."""
    if isinstance(x, dict):
        return type(x)({k: _map(v, fn) for k, v in x.items()})
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_map(v, fn) for v in x)
    return fn(x)


def _to_host(x):
    return _map(x, lambda v: v.detach().cpu() if torch.is_tensor(v) else v)


def _to_device(x, device: torch.device):
    return _map(x, lambda v: v.to(device) if torch.is_tensor(v) else v)


def _worker_env(connection, make_env_fn: Callable, env_fn_args: Tuple, auto_reset_done: bool) -> None:
    """Worker loop (reference vector_env.py:234-301): build the env, then
    serve commands until CLOSE. An exception is sent back with its traceback
    and ends the worker."""
    command, env = MAKE_ENV_COMMAND, None
    try:
        env = make_env_fn(*env_fn_args)
        while True:
            command, data = connection.recv()
            if command == STEP_COMMAND:
                out = env.step(data)
                if isinstance(out, tuple) and len(out) == 4:
                    obs, reward, done, info = out
                    if auto_reset_done and done:
                        obs = env.reset()
                    connection.send((obs, reward, done, info))
                else:
                    if auto_reset_done and getattr(env, "episode_over", False):
                        out = env.reset()
                    connection.send(out)
            elif command == RESET_COMMAND:
                connection.send(env.reset())
            elif command == RENDER_COMMAND:
                connection.send(env.render(*data[0], **data[1]))
            elif command == CALL_COMMAND:
                function_name, function_args = data
                fn = getattr(env, function_name)
                connection.send(fn(**(function_args or {})) if callable(fn) else fn)
            elif command == COUNT_EPISODES_COMMAND:
                connection.send(len(getattr(env, "episodes", [])))
            elif command == CLOSE_COMMAND:
                connection.send(None)
                break
            else:
                raise RuntimeError(f"unknown command {command!r}")
    except Exception:
        try:
            connection.send(_WorkerError(command, traceback.format_exc()))
        except Exception:
            pass
    finally:
        if env is not None:
            try:
                env.close()
            except Exception:
                pass


class _PipeConn:
    """One end of a process pipe: host copies pickled with the standard
    pickler."""

    def __init__(self, conn):
        self._conn = conn

    def send(self, x) -> None:
        self._conn.send_bytes(pickle.dumps(_to_host(x), protocol=pickle.HIGHEST_PROTOCOL))

    def recv(self):
        return pickle.loads(self._conn.recv_bytes())

    def poll(self, timeout: float) -> bool:
        return self._conn.poll(timeout)

    def close(self) -> None:
        self._conn.close()


class _ThreadConn:
    """Duplex queue pair with the pipe's send / recv / poll surface, for the
    threaded variant (same worker loop, nothing pickled)."""

    def __init__(self, inbox: _queue.Queue, outbox: _queue.Queue):
        self._in, self._out = inbox, outbox
        self._held: List[Any] = []

    def send(self, x) -> None:
        self._out.put(x)

    def poll(self, timeout: float) -> bool:
        if not self._held:
            try:
                self._held.append(self._in.get(timeout=timeout))
            except _queue.Empty:
                return False
        return True

    def recv(self):
        return self._held.pop() if self._held else self._in.get()

    def close(self) -> None:
        pass


class _Worker:
    """One env worker: its parent-side connection, its process or thread,
    its index at construction and the command it was last sent."""

    def __init__(self, index: int, conn, handle):
        self.index, self.conn, self.handle = index, conn, handle
        self.pending = False  # one-outstanding-message discipline
        self.dead = False
        self.command: Optional[str] = None

    def alive(self) -> bool:
        return self.handle.is_alive()

    def exitcode(self):
        return getattr(self.handle, "exitcode", None)

    def join(self, timeout: float) -> None:
        self.handle.join(timeout=timeout)
        if self.handle.is_alive() and hasattr(self.handle, "terminate"):
            self.handle.terminate()
            self.handle.join(timeout=timeout)


def _all_or_first_error(calls) -> List[Any]:
    """Every call's result; when some raise, all still run (so no worker is
    left with a reply outstanding) and the first error is raised."""
    out, error = [], None
    for call in calls:
        try:
            out.append(call())
        except RuntimeError as e:
            error = error or e
    if error is not None:
        raise error
    return out


def _prebuild(device: torch.device) -> None:
    """Build what the workers' envs load at first use, once, here."""
    from habitat_torch import native

    native.ensure_built()
    if device.type == "cuda":
        from habitat_torch.ops import cuda_build

        cuda_build.ensure_built()


class VectorEnv:
    """Process-backed vectorized envs (reference vector_env.py:135); results
    come back as host copies put on ``device`` (``None`` = cuda)."""

    def __init__(
        self,
        make_env_fn: Callable,
        env_fn_args: Sequence[Tuple] = (),
        auto_reset_done: bool = True,
        multiprocessing_start_method: str = "forkserver",
        workers_ignore_signals: bool = False,
        device=None,
    ) -> None:
        assert len(env_fn_args) > 0, "VectorEnv requires at least one env"
        self.device = resolve_device(device)
        self._auto_reset_done = auto_reset_done
        self._workers: List[_Worker] = []
        self._paused: List[Tuple[int, _Worker]] = []
        self._is_closed = False
        _prebuild(self.device)
        _OPEN.add(self)
        try:
            self._spawn_workers(make_env_fn, env_fn_args, multiprocessing_start_method)
            self.observation_shapes = self._call_each("observation_shapes")
            self.action_names = self._call_each("action_names")
            self.orig_action_names = list(self.action_names)
            self.number_of_episodes = self._call_each("number_of_episodes")
        except BaseException:
            self.close()
            raise

    # -- worker management --------------------------------------------------
    def _spawn_workers(self, make_env_fn, env_fn_args, start_method) -> None:
        ctx = multiprocessing.get_context(start_method)
        for i, args in enumerate(env_fn_args):
            parent_conn, child_conn = ctx.Pipe()
            proc = ctx.Process(
                target=_worker_env,
                args=(_PipeConn(child_conn), make_env_fn, args, self._auto_reset_done),
                daemon=True,
            )
            proc.start()
            child_conn.close()
            self._workers.append(_Worker(i, _PipeConn(parent_conn), proc))

    def _send(self, w: _Worker, msg) -> None:
        if w.dead:
            raise RuntimeError(f"worker {w.index} has ended after an error; it cannot run {msg[0]!r}")
        w.command = msg[0]
        try:
            w.conn.send(msg)
        except OSError:  # the worker has ended: report its last words
            self._receive(w)
            w.dead = True
            raise RuntimeError(f"worker {w.index} ended before {msg[0]!r} (exit code {w.exitcode()})")

    def _died(self, w: _Worker) -> RuntimeError:
        w.dead = True
        w.join(timeout=5)
        return RuntimeError(
            f"worker {w.index} ended without replying to {w.command!r} (exit code {w.exitcode()})")

    def _receive(self, w: _Worker, timeout: Optional[float] = None):
        """The worker's reply on ``device``; raises ``RuntimeError`` when the
        worker forwarded an error, ended without a reply, or (with
        ``timeout``) stayed silent that long."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not w.conn.poll(_POLL_S):
            if not w.alive() and not w.conn.poll(0):
                raise self._died(w)
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"worker {w.index} did not answer {w.command!r} within {timeout} s")
        try:
            out = w.conn.recv()
        except (EOFError, OSError):
            raise self._died(w) from None
        if isinstance(out, _WorkerError):
            w.dead = True
            raise RuntimeError(f"worker {w.index} raised in {out.command!r}:\n{out.text}")
        return _to_device(out, self.device)

    def _req(self, w: _Worker, msg) -> Any:
        self._send(w, msg)
        return self._receive(w)

    def _broadcast(self, msgs) -> List[Any]:
        """Send each worker its message, then collect every reply."""
        for w, msg in zip(self._workers, msgs):
            self._send(w, msg)
        return _all_or_first_error([lambda w=w: self._receive(w) for w in self._workers])

    def _call_each(self, name: str) -> List[Any]:
        return self._broadcast([(CALL_COMMAND, (name, None))] * self.num_envs)

    @property
    def num_envs(self) -> int:
        return len(self._workers)

    # -- reset -------------------------------------------------------------
    def reset(self) -> List[Any]:
        return self._broadcast([(RESET_COMMAND, None)] * self.num_envs)

    def reset_at(self, index_env: int):
        return self._req(self._workers[index_env], (RESET_COMMAND, None))

    # -- step --------------------------------------------------------------
    def async_step_at(self, index_env: int, action) -> None:
        w = self._workers[index_env]
        assert not w.pending, "Already waiting on a step for this env"  # one-outstanding-message
        self._send(w, (STEP_COMMAND, action))
        w.pending = True

    def wait_step_at(self, index_env: int):
        w = self._workers[index_env]
        assert w.pending, "No pending step for this env"
        w.pending = False
        return self._receive(w)

    def async_step(self, data: Sequence) -> None:
        for i, action in enumerate(data):
            self.async_step_at(i, action)

    def wait_step(self) -> List[Any]:
        return _all_or_first_error([lambda i=i: self.wait_step_at(i) for i in range(self.num_envs)])

    def step(self, data: Sequence) -> List[Any]:
        """Synchronous batched step (reference vector_env.py:440): actions
        fan out to every worker before any result is awaited."""
        self.async_step(data)
        return self.wait_step()

    def step_at(self, index_env: int, action):
        self.async_step_at(index_env, action)
        return self.wait_step_at(index_env)

    def post_step(self, observations):
        """Batch-renderer hook (reference :451); the frames are already
        rendered, so identity."""
        return observations

    # -- pause/resume (reference :486-510) ----------------------------------
    def pause_at(self, index: int) -> None:
        w = self._workers.pop(index)
        self.observation_shapes.pop(index)
        self.action_names.pop(index)
        self._paused.append((index, w))  # worker stays alive, unqueried

    def resume_all(self) -> None:
        for index, w in reversed(self._paused):
            self._workers.insert(index, w)
            self.observation_shapes.insert(index, self._req(w, (CALL_COMMAND, ("observation_shapes", None))))
            self.action_names.insert(index, self._req(w, (CALL_COMMAND, ("action_names", None))))
        self._paused = []

    # -- call-by-name (reference :511-556) -----------------------------------
    def call_at(self, index: int, function_name: str, function_args: Optional[Dict[str, Any]] = None) -> Any:
        return self._req(self._workers[index], (CALL_COMMAND, (function_name, function_args)))

    def call(self, function_names: List[str], function_args_list: Optional[List[Any]] = None) -> List[Any]:
        if function_args_list is None:
            function_args_list = [None] * len(function_names)
        return self._broadcast([(CALL_COMMAND, (fn, args)) for fn, args in zip(function_names, function_args_list)])

    def count_episodes(self) -> List[int]:
        return self._broadcast([(COUNT_EPISODES_COMMAND, None)] * self.num_envs)

    def render(self, mode: str = "human", *args, **kwargs) -> np.ndarray:
        """Every env's ``render("rgb")`` tiled into one image."""
        from habitat_torch.utils.visualizations.utils import tile_images

        images = self._broadcast([(RENDER_COMMAND, (("rgb",), {}))] * self.num_envs)
        return tile_images([np.asarray(im) for im in images])

    def close(self) -> None:
        if self._is_closed:
            return
        self._is_closed = True
        workers = self._workers + [w for _, w in self._paused]
        self._paused = []
        closing = []
        for w in workers:
            try:
                if w.pending:  # drain an in-flight step first
                    w.pending = False
                    self._receive(w, _CLOSE_TIMEOUT_S)
                self._send(w, (CLOSE_COMMAND, None))
                closing.append(w)
            except RuntimeError:
                pass
        for w in closing:
            try:
                self._receive(w, _CLOSE_TIMEOUT_S)
            except RuntimeError:
                pass
        for w in workers:
            w.conn.close()
            w.join(timeout=5)

    def __del__(self):
        if hasattr(self, "_is_closed") and not sys.is_finalizing():
            self.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


class ThreadedVectorEnv(VectorEnv):
    """Same API over worker THREADS (reference vector_env.py:622-668): the
    HABITAT_ENV_DEBUG mode, and the variant for a ``make_env_fn`` that is a
    closure (nothing is pickled)."""

    def _spawn_workers(self, make_env_fn, env_fn_args, start_method) -> None:
        for i, args in enumerate(env_fn_args):
            to_worker: _queue.Queue = _queue.Queue()
            to_parent: _queue.Queue = _queue.Queue()
            th = threading.Thread(
                target=_worker_env,
                args=(_ThreadConn(to_worker, to_parent), make_env_fn, args, self._auto_reset_done),
                daemon=True,
            )
            th.start()
            self._workers.append(_Worker(i, _ThreadConn(to_parent, to_worker), th))
