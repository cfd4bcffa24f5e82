"""Data parallelism over ``torch.distributed``: the port of
``mfnerf_tpu/parallel/mesh.py``.

The reference's only parallelism is DDP over ray batches (NCCL all-reduce;
SURVEY §2.4). The JAX package runs one program over a 1-D ``data`` mesh: the
ray batch is sharded on its ray axis into contiguous equal shards
(``constrain_batch``), parameters, optimiser state, occupancy and poses are
replicated, and GSPMD inserts the gradient all-reduce. Here each shard is a
process (a rank) with its own device, and the collectives are explicit:

* :class:`Shard`: the rank's contiguous slice of a global batch, and the
  exclusive prefix of a per-rank count (the samples of the ranks before it,
  for the flat budget and the hash grids' gradient noise);
* :func:`average_gradients`: one flat all-reduce a step of every gradient
  the optimiser holds (a bucket per dtype), divided by the world size; given
  the set of parameters with a gradient that an earlier call returned, with
  no host read, so that a CUDA graph can capture it (NCCL only: gloo's
  collectives run on the host);
* :func:`gather_rows` and :func:`allgather_ragged`: the renderer's rows and
  the validation metrics, each rank's part written into a zero-filled
  buffer and summed (``all_reduce`` alone, which gloo also takes for CUDA
  tensors, so two ranks can share one card in a test);
* :func:`spawn` starts the ranks (the ``spawn`` context, a free localhost
  port) and :func:`join_from_env` joins the group ``torchrun`` made.

NCCL joins ranks on distinct cards, one card a rank (``cuda:LOCAL_RANK``);
gloo joins CPU ranks, and ranks that share a card (test device lists only).
"""
import dataclasses
import datetime
import itertools
import os
import queue as queue_lib
import socket
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device

TIMEOUT = 1800          # seconds a rank waits in a collective, and a spawn


def world(group=None):
    """(rank, world size) of this process: (0, 1) without a process group."""
    if not in_group():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def in_group():
    """True inside a process group, even of one rank."""
    return dist.is_available() and dist.is_initialized()


def backend():
    """The process group's backend ("nccl" or "gloo"), None outside one."""
    return dist.get_backend() if in_group() else None


def rank_devices(num, device=None, devices=None):
    """The device of each of ``num`` ranks: ``devices`` where given (tests:
    ranks may share a card), else ``num`` CPU ranks for ``device="cpu"``,
    else the first ``num`` cards, one a rank. Asking for more cards than
    the machine has raises ``ValueError("requested N devices, have M")``,
    as the JAX ``make_mesh`` does: ranks never share a card and are never
    fewer than asked for."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != num:
            raise ValueError(f"{len(devs)} devices for {num} ranks")
        return devs
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * num
    have = torch.cuda.device_count()
    if num > have:
        raise ValueError(f"requested {num} devices, have {have}")
    return [torch.device("cuda", i) for i in range(num)]


def backend_for(devices):
    """NCCL for distinct cards, gloo for CPU ranks or a shared card."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class Shard:
    """Rank ``rank`` of ``world``'s contiguous slice of a global batch of
    ``n_global`` rays, and the collectives a step needs, on ``device``."""
    rank: int
    world: int
    n_global: int
    device: torch.device

    @classmethod
    def of(cls, batch_size, device):
        """This process's shard of a batch of ``batch_size`` rays; the batch
        must split into equal shards (the JAX mesh shards the same axis)."""
        rank, size = world()
        if batch_size % size:
            raise ValueError(f"batch_size {batch_size} does not split into "
                             f"{size} equal shards")
        return cls(rank, size, batch_size, torch.device(device))

    @property
    def lo(self):
        return self.rank * (self.n_global // self.world)

    @property
    def hi(self):
        return self.lo + self.n_global // self.world

    def take(self, x):
        """This rank's rows of a global batch tensor."""
        return x[self.lo:self.hi]

    def prefix(self, count):
        """(the ranks before this one's total of ``count``, every rank's
        total): an exclusive prefix, as int64 0-d tensors on the device."""
        buf = torch.zeros(self.world, dtype=torch.int64, device=self.device)
        buf[self.rank] = count
        dist.all_reduce(buf)
        return buf[:self.rank].sum(), buf.sum()


def average_gradients(params, present=None):
    """Replace each parameter's gradient by its mean over the ranks: one
    flat all-reduce a dtype (the parameters' gradients and a flag a
    parameter, so that one with no gradient on any rank keeps none),
    divided by the world size. Every rank passes the same parameters in the
    same order.

    Returns ``present``: a tuple of a bool a parameter, whether it carries
    a gradient, where every rank agrees on each (else None). The flags are
    read back on the host to decide that. Given ``present`` (what an
    earlier call returned for parameters whose gradients every rank holds
    alike, as a training step of one kind does), nothing is read or copied
    from the host: the flags are written on the device and ``present``
    decides, so a CUDA graph can capture the call, and its gradients are
    bit for bit what the call without it gives (the same buffer, reduced
    alike). A rank whose gradients do not match ``present`` raises."""
    params = list(params)
    _, size = world()
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    agreed = []
    for ps in by_dtype.values():
        local = [p.grad is not None for p in ps]
        if present is not None:
            want = [present[i] for i, p in enumerate(params)
                    if p.dtype == ps[0].dtype]
            if local != want:
                raise ValueError(
                    f"this rank's gradients {local} are not the set "
                    f"{want} that the step was captured with")
        # the flags made on the device, a fill a run of ones: no copy from
        # the host
        flags = torch.zeros(len(ps), dtype=ps[0].dtype, device=ps[0].device)
        lo = 0
        for has, run in itertools.groupby(local):
            hi = lo + len(list(run))
            if has:
                flags[lo:hi].fill_(1)
            lo = hi
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1) for p in ps]
                         + [flags])
        dist.all_reduce(flat)
        flat.div_(size)
        if present is None:
            share = flat[flat.numel() - len(ps):].tolist()
            has_grad = [v > 0 for v in share]
            agreed.append(all(v in (0.0, 1.0) for v in share))
        else:
            has_grad = want
        off = 0
        for i, p in enumerate(ps):
            n = p.numel()
            if has_grad[i]:
                if p.grad is None:
                    p.grad = flat[off:off + n].view_as(p).clone()
                else:
                    p.grad.copy_(flat[off:off + n].view_as(p))
            off += n
    if present is not None:
        return present
    return tuple(p.grad is not None for p in params) if all(agreed) \
        else None


def all_sum(x, group=None):
    """``x`` summed over the ranks (in place; returned)."""
    dist.all_reduce(x, group=group)
    return x


def gather_rows(local, n_global, lo, group=None):
    """Every rank's rows in one (n_global, ...) tensor: rank r's ``local``
    at rows ``lo_r``... of a zero-filled buffer, summed over the ranks
    (x + 0 is x exactly)."""
    buf = local.new_zeros((n_global,) + tuple(local.shape[1:]))
    buf[lo:lo + local.shape[0]] = local
    dist.all_reduce(buf, group=group)
    return buf


def allgather_ragged(vals, n_max, device="cpu"):
    """Gather each rank's ragged list of per-image metrics
    (``mfnerf_tpu/train.py::allgather_ragged``): this rank's list padded to
    ``n_max`` with NaN, a (world, n_max) float64 buffer summed over the
    ranks, the padding dropped; ranks in order. NaN, not -1, is the
    sentinel: SSIM can be negative. Outside a process group: the list."""
    if not in_group():
        return list(vals)
    rank, size = world()
    buf = torch.zeros((size, n_max), dtype=torch.float64, device=device)
    buf[rank] = float("nan")
    buf[rank, :len(vals)] = torch.tensor(vals, dtype=torch.float64)
    dist.all_reduce(buf)
    flat = buf.reshape(-1).cpu()
    return flat[~torch.isnan(flat)].tolist()


def free_port():
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(rank, world_size, device, backend, init_method, timeout=TIMEOUT):
    """Join the process group as ``rank`` of ``world_size`` on ``device``
    (a card becomes this process's current device)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))


def join_from_env():
    """Join the group that ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) over NCCL, on card
    ``LOCAL_RANK``; returns that device, or None outside ``torchrun``."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    resolve_device(device)
    if not dist.is_initialized():
        init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), device,
             "nccl", "env://")
    return device


def _entry(fn, rank, devices, backend, init_method, timeout, args, results):
    try:
        init(rank, len(devices), devices[rank], backend, init_method,
             timeout)
        out = fn(rank, torch.device(devices[rank]), *args)
        results.put((rank, True, out))
    except BaseException:        # the parent raises it with the traceback
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, devices, args=(), timeout=TIMEOUT):
    """Run ``fn(rank, device, *args)`` in one new process a rank, on
    ``devices`` (one a rank), joined in a process group on a free localhost
    port (:func:`backend_for`); return the ranks' results in rank order.
    ``fn`` and ``args`` must pickle (``fn`` a module-level function). A
    rank that fails, or a run that outlasts ``timeout`` seconds, ends every
    rank and raises ``RuntimeError``."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    devices = [str(torch.device(d)) for d in devices]
    init_method = f"tcp://127.0.0.1:{free_port()}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(
        fn, rank, devices, backend_for(devices), init_method, timeout, args,
        results)) for rank in range(len(devices))]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, failed = {}, None
    try:
        while len(out) < len(procs) and failed is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in out]
                if dead or time.monotonic() >= deadline:
                    failed = (f"rank(s) {dead} ended without a result" if dead
                              else f"timed out after {timeout} s")
                continue
            if ok:
                out[rank] = value
            else:
                failed = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=10 if failed is None else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    if failed is not None:
        raise RuntimeError(failed)
    return [out[rank] for rank in range(len(procs))]
