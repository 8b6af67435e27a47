"""Host-to-device batch prefetch (port of ``vfd_gan_tpu.parallel.prefetch``).

``device_prefetch(iterator, device, depth)`` yields the iterator's batches
in order, each field but ``index`` as a tensor on ``device``, with up to
``depth`` batches copied ahead of the one the consumer holds.

For host batches (numpy arrays or CPU tensors) and a CUDA device, a
staging thread takes the next batch from the iterator, copies each field
into one of ``depth + 1`` reused pinned buffers and queues the
host-to-device copy on a side stream (``non_blocking``), followed by an
event.  The host copy into pinned memory and the transfer both overlap the
consumer's step; before a batch is yielded the consumer's stream is made to
wait for its event, and its tensors are recorded on that stream, so the
caching allocator does not hand their memory on while the step that reads
them is queued.  A pinned buffer is rewritten only after the event of the
copy that last read it has completed.

Batches whose fields already lie on ``device`` (the on-device synthetic
iterator) and CPU targets pass through unchanged, on the caller's thread.
"""

from __future__ import annotations

import queue
import threading

import torch

# the field that stays on the host: clip ids, read as Python ints
HOST_FIELDS = ("index",)
_END = object()


def _on_device(batch: dict, device: torch.device) -> bool:
    return all(isinstance(v, torch.Tensor) and v.device.type == device.type
               for k, v in batch.items() if k not in HOST_FIELDS)


class _Stager:
    """Pinned staging buffers and the side stream of one prefetch run."""

    def __init__(self, device: torch.device, slots: int, h2d_events):
        self.device = device
        self.slots = slots
        self.stream = torch.cuda.Stream(device)
        self.pinned: list[dict] = [{} for _ in range(slots)]
        self.done: list = [None] * slots     # event of a slot's last copy
        self.h2d_events = h2d_events
        self.n = 0

    def __call__(self, batch: dict):
        slot = self.n % self.slots
        self.n += 1
        if self.done[slot] is not None:
            self.done[slot].synchronize()
        out = {k: batch[k] for k in HOST_FIELDS if k in batch}
        staged = {}
        for k, v in batch.items():
            if k in HOST_FIELDS:
                continue
            src = torch.as_tensor(v)
            buf = self.pinned[slot].get(k)
            if buf is None or buf.shape != src.shape \
                    or buf.dtype != src.dtype:
                buf = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True)
                self.pinned[slot][k] = buf
            buf.copy_(src)
            staged[k] = buf
        timed = self.h2d_events is not None
        start = torch.cuda.Event(enable_timing=timed)
        end = torch.cuda.Event(enable_timing=timed)
        with torch.cuda.stream(self.stream):
            start.record()
            for k, buf in staged.items():
                out[k] = buf.to(self.device, non_blocking=True)
            end.record()
        self.done[slot] = end
        if timed:
            self.h2d_events.append((start, end))
        return out, end


def _staged_ahead(first, it, stage, depth: int):
    """``(staged batch, event)`` pairs in order: ``first`` and then the
    rest of ``it``, each through ``stage`` on a thread that runs up to
    ``depth`` batches ahead of the consumer.  An exception of the iterator
    or of ``stage`` is raised in the consumer at its place in the order."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            batch = first
            while put(stage(batch)):
                batch = next(it, _END)
                if batch is _END:
                    put(_END)
                    return
        except Exception as e:  # handed to the consumer
            put(e)
        finally:
            if stop.is_set() and hasattr(it, "close"):
                it.close()      # an early exit: let the iterator clean up

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=30)


def device_prefetch(iterator, device, depth: int = 2, h2d_events=None):
    """Yield ``iterator``'s batches with their fields on ``device``,
    ``depth`` copies ahead (module docstring).  ``h2d_events``: a list that
    receives one ``(start, end)`` pair of timing CUDA events around each
    batch's copies on the side stream."""
    device = torch.device(device)
    depth = max(1, depth)
    it = iter(iterator)
    first = next(it, _END)
    if first is _END:
        return
    if device.type != "cuda" or _on_device(first, device):
        yield first
        yield from it
        return
    staged = _staged_ahead(first, it, _Stager(device, depth + 1, h2d_events),
                           depth)
    try:
        for batch, event in staged:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for k, v in batch.items():
                if k not in HOST_FIELDS:
                    v.record_stream(current)
            yield batch
    finally:
        staged.close()          # stops and joins the staging thread


def to_device(batch: dict, device: torch.device) -> dict:
    """The clip fields of a batch as tensors on ``device``: a no-op for a
    prefetched batch, a plain (blocking) copy for a host batch."""
    return {k: (v if k in HOST_FIELDS else
                torch.as_tensor(v).to(device))
            for k, v in batch.items()}
