"""Object serialization for the cluster runtime: pickle protocol 5 with
out-of-band buffers, nested ``ObjectRef`` recording, and callables by
reference (the port's copy of ``ray_tpu/_private/serialization.py``:
``Serializer`` :154, ``_RefPickler`` :119, ``serialize_error`` :193).

Two rules differ from JAX's, which pickles with cloudpickle:

* **Callables cross by reference.** The card's machine has no
  cloudpickle, so a function or class is written as its module and
  qualified name and imported again where it is read, as the process
  runtime's replicas import theirs (``runtime/replica.py::reference``).
  A name that resolves to a ``@remote`` wrapper (a
  :class:`~ray_tpu_torch.remote_function.RemoteFunction`, an
  :class:`~ray_tpu_torch.actor.ActorClass` or a serve ``Deployment``)
  stands for the function or class it wraps. A lambda, a closure or a
  class defined inside a function has no such name: pickling one raises
  a ``TypeError`` that says the callable must be defined at module level.
* **A tensor's bytes go out of band.** torch pickles a CPU tensor's
  storage in-band, so its bytes would be copied into the pickle and never
  reach a shared-memory segment whole. The pickler writes a plain dense
  tensor as a numpy view of its bytes (a bf16 tensor as its 16-bit
  integers) and a dtype tag; the view's buffer goes out of band, and the
  reader gets ``torch.from_numpy`` of the array it reads. A get from the
  node's store hands a tensor over the mapped segment, without a copy
  (``_private/shm.py`` says what a reader may do with it); a tensor read
  from a message's bytes is a copy, since those bytes are immutable.
* **A CUDA tensor is written as a host tensor.** Pickled as it is, a
  tensor carries its device index, and in a process with another
  ``CUDA_VISIBLE_DEVICES`` that index names another card or none at all;
  the reader gets the values on the host and moves them where it wants.

Wire format of a serialized object (as JAX's)::

    [u32 pickle_len][u8 is_error][u32 nbuf][u32 nrefs]([u32 len][ref])*
    [u64 len_i]* [pickle] [buf_0] [buf_1] ...
"""

from __future__ import annotations

import importlib
import io
import pickle
import struct
import sys
import types
from typing import Any, List

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.ids import ObjectID

_HDR = struct.Struct("<IBI")
_OOB_THRESHOLD = 4096  # buffers smaller than this are kept in-band

MODULE_LEVEL_RULE = (
    "the cluster runtime sends functions and classes by reference (module "
    "and qualified name, imported again in the worker), so {what} must be "
    "defined at module level of an importable module")


class SerializedObject:
    """A pickled value plus its out-of-band buffers and contained refs."""

    __slots__ = ("pickled", "buffers", "contained_refs", "is_error")

    def __init__(self, pickled: bytes, buffers: List[pickle.PickleBuffer],
                 contained_refs: List[bytes], is_error: bool):
        self.pickled = pickled
        self.buffers = buffers
        self.contained_refs = contained_refs
        self.is_error = is_error

    def total_bytes(self) -> int:
        """The pickle's and the out-of-band buffers' bytes."""
        return len(self.pickled) + sum(memoryview(b).nbytes
                                       for b in self.buffers)

    def wire_size(self) -> int:
        """The exact length of :meth:`to_bytes` (and of :meth:`to_parts`
        joined)."""
        return (_HDR.size + 4 + sum(4 + len(r) for r in self.contained_refs)
                + 8 * len(self.buffers) + self.total_bytes())

    def to_parts(self) -> List[Any]:
        """The wire encoding as a list of buffers, not joined: written
        with ``os.writev``, a large out-of-band buffer is copied once,
        into its destination (a shared-memory segment)."""
        views = [memoryview(b).cast("B") for b in self.buffers]
        parts: List[Any] = [
            _HDR.pack(len(self.pickled), 1 if self.is_error else 0,
                      len(views)),
            struct.pack("<I", len(self.contained_refs))]
        for r in self.contained_refs:
            parts += [struct.pack("<I", len(r)), r]
        parts += [struct.pack("<Q", v.nbytes) for v in views]
        parts.append(self.pickled)
        parts.extend(views)
        return parts

    def to_bytes(self) -> bytes:
        return b"".join(self.to_parts())

    @staticmethod
    def parse(data) -> "SerializedObject":
        mv = memoryview(data)
        plen, is_err, nbuf = _HDR.unpack_from(mv, 0)
        off = _HDR.size
        (nrefs,) = struct.unpack_from("<I", mv, off)
        off += 4
        refs = []
        for _ in range(nrefs):
            (rlen,) = struct.unpack_from("<I", mv, off)
            off += 4
            refs.append(bytes(mv[off:off + rlen]))
            off += rlen
        blens = []
        for _ in range(nbuf):
            blens.append(struct.unpack_from("<Q", mv, off)[0])
            off += 8
        pickled = bytes(mv[off:off + plen])
        off += plen
        buffers = []
        for blen in blens:
            buffers.append(pickle.PickleBuffer(mv[off:off + blen]))
            off += blen
        return SerializedObject(pickled, buffers, refs, bool(is_err))


def _lookup(module: str, qualname: str):
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _unwrap(obj):
    """The function or class a ``@remote`` or ``@serve.deployment``
    wrapper stands for; ``obj`` itself for anything else."""
    from ray_tpu_torch.actor import ActorClass
    from ray_tpu_torch.remote_function import RemoteFunction

    if isinstance(obj, RemoteFunction):
        return obj._function
    if isinstance(obj, ActorClass):
        return obj._cls
    inner = None if isinstance(obj, type) else getattr(obj, "_cls_or_fn",
                                                       None)
    return obj if inner is None else inner


def resolve_callable(module: str, qualname: str):
    """The function or class ``module.qualname`` names, unwrapped."""
    return _unwrap(_lookup(module, qualname))


def _reduce_callable(obj):
    """How a function or class crosses: pickle's own global reference when
    its name resolves to it, ``resolve_callable`` when the name holds its
    ``@remote`` wrapper, and a ``TypeError`` naming the rule for a lambda,
    a closure, a class defined in a function or a function no import
    finds."""
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None)
    what = f"{type(obj).__name__} {qualname!r} of module {module!r}"
    if not module or not qualname or "<locals>" in qualname or \
            "<lambda>" in qualname:
        raise TypeError(MODULE_LEVEL_RULE.format(what=what))
    try:
        found = _lookup(module, qualname)
    except (ImportError, AttributeError):
        found = None
    if found is obj:
        return NotImplemented
    if found is not None and _unwrap(found) is obj:
        return resolve_callable, (module, qualname)
    if isinstance(obj, types.FunctionType):
        raise TypeError(MODULE_LEVEL_RULE.format(what=what))
    return NotImplemented


# A tensor dtype the numpy view carries its bytes as, where numpy has no
# dtype of its own.
_VIEW_AS = {"bfloat16": "int16"}


def _tensor_from_numpy(array, dtype: str, requires_grad: bool):
    """The reader's end of :func:`_reduce_tensor`: a tensor over
    ``array``'s buffer. A read-only buffer is either a store segment this
    process mapped, which takes writes copy-on-write (the tensor aliases
    it: ``shm.writable_alias``), or the bytes of a message (an inline
    argument, result or pulled chunk), which a write must not reach (the
    tensor gets a copy)."""
    import torch

    if not array.flags.writeable:
        from ray_tpu_torch._private import shm

        alias = shm.writable_alias(array)
        array = array.copy() if alias is None else alias
    t = torch.from_numpy(array)
    if dtype in _VIEW_AS:
        t = t.view(getattr(torch, dtype))
    if requires_grad:
        t.requires_grad_(True)
    return t


def _reduce_tensor(torch, obj):
    """A plain dense CPU or CUDA tensor as a numpy view of its bytes and
    its dtype, so the bytes leave the pickle as an out-of-band buffer; a
    tensor of another kind (a subclass, sparse, quantized, a dtype numpy
    cannot view) as torch writes it, a CUDA one moved to the host."""
    host = obj
    if obj.device.type == "cuda":
        host = obj.detach().to("cpu")
    plain = (type(obj) is torch.Tensor and host.layout == torch.strided
             and host.device.type == "cpu" and not host.is_quantized
             and not host.is_conj() and not host.is_neg())
    dtype = str(host.dtype).split(".")[-1]
    if plain:
        try:
            view = host.detach()
            if dtype in _VIEW_AS:
                view = view.view(getattr(torch, _VIEW_AS[dtype]))
            array = view.numpy()
        except (TypeError, RuntimeError):
            plain = False
    if not plain:
        return host.as_subclass(torch.Tensor).__reduce_ex__(5) \
            if host is not obj else NotImplemented
    return _tensor_from_numpy, (array, dtype, bool(obj.requires_grad))


class _RefPickler(pickle.Pickler):
    """Protocol-5 pickler recording nested ObjectRefs (``contained``),
    writing callables by reference and tensors through numpy views."""

    def __init__(self, file, buffer_callback, contained):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        self._contained = contained

    def persistent_id(self, obj):  # noqa: D401 — pickle API
        from ray_tpu_torch._private.object_ref import ObjectRef

        if isinstance(obj, ObjectRef):
            self._contained.append(obj.binary())
            return ("ray_tpu.ObjectRef", obj.binary(), obj.owner_address())
        return None

    def reducer_override(self, obj):
        if isinstance(obj, (types.FunctionType, type)):
            return _reduce_callable(obj)
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            return _reduce_tensor(torch, obj)
        return NotImplemented


class _RefUnpickler(pickle.Unpickler):
    def __init__(self, file, buffers, ref_deserializer):
        super().__init__(file, buffers=buffers)
        self._ref_deserializer = ref_deserializer

    def persistent_load(self, pid):  # noqa: D401 — pickle API
        tag, binary, owner = pid
        if tag != "ray_tpu.ObjectRef":
            raise pickle.UnpicklingError(f"unknown persistent id {tag!r}")
        from ray_tpu_torch._private.object_ref import ObjectRef

        ref = ObjectRef(ObjectID(binary), owner_address=owner)
        if self._ref_deserializer is not None:
            self._ref_deserializer(ref)
        return ref


class Serializer:
    """Pickles and unpickles values, recording nested ObjectRefs; state is
    per call, so one instance may be shared by threads."""

    def __init__(self, ref_deserializer=None):
        self.ref_deserializer = ref_deserializer

    def serialize(self, value: Any) -> SerializedObject:
        contained: List[bytes] = []
        buffers: List[pickle.PickleBuffer] = []

        def buffer_callback(pb: pickle.PickleBuffer) -> bool:
            if memoryview(pb).nbytes < _OOB_THRESHOLD:
                return True  # small buffers stay in-band
            buffers.append(pb)
            return False

        is_error = isinstance(value, exceptions.RayTpuError)
        f = io.BytesIO()
        _RefPickler(f, buffer_callback, contained).dump(value)
        return SerializedObject(f.getvalue(), buffers, contained, is_error)

    def deserialize(self, s: SerializedObject) -> Any:
        return _RefUnpickler(io.BytesIO(s.pickled), s.buffers,
                             self.ref_deserializer).load()


def dumps(value: Any) -> bytes:
    """One value as the wire's bytes (the cluster runtime's
    ``ClusterRuntime.dumps`` also stores the refs it carries)."""
    return Serializer().serialize(value).to_bytes()


def loads(data) -> Any:
    return Serializer().deserialize(SerializedObject.parse(data))


def serialize_error(exc: BaseException, function_name: str, task_id=None):
    """Wrap an executor-side exception as a storable RayTaskError value."""
    if isinstance(exc, exceptions.RayTaskError):
        return exc
    return exceptions.RayTaskError.from_exception(exc, function_name,
                                                  task_id)
