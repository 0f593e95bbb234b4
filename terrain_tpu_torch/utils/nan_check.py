"""TERRAIN_CHECK_NANS=2: NaN checks inside the train and eval steps.

The JAX package compiles each step under `checkify.float_checks`
(terrain_tpu/train/trainer.py:_jit_step): every primitive whose floating
output holds a NaN sets an error, the first one in program order is kept,
and the step raises it naming the op.  Inf alone raises nothing (checkify's
division checks are for integers only).  This is the port's counterpart:

  * a `TorchDispatchMode` sees every aten op of the step, forward and
    backward (the autograd engine's threads inherit the mode), the losses
    and the optimizer update included; after each op it writes
    `any(isnan(output))` of every floating output (and every tensor the op
    wrote in place) into one slot of a flag buffer on the device;
  * the hand-written kernels launch through ctypes, below the dispatcher:
    each wrapper hands its outputs to `kernel_outputs` after the launch,
    which checks them alike, under the kernel's name;
  * a table built as the checks are recorded maps each slot to (the step
    within the chunk, the network, the module path of the forward layer,
    the op): module hooks keep the forward layer, and the autograd nodes
    a layer's forward made carry it for their backward ops.

The checks only read: the step computes the same values.  They are device
ops writing into a fixed buffer, so a CUDA graph captures them with the
step (train/step.py CapturedSteps): the table is built at capture, a
replay rewrites every slot, and the host reads the buffer once a chunk
(`hit`, then `raise_first`), or once a step when eager.  A debug mode: it
costs one or two small kernels an op output, and the Python of the mode
on every eager op.
"""

import contextlib
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the slots of one flag buffer: enough for a chunk of 16 flagship steps
# (~5,000 checked outputs each) several times over
CAPACITY = 1 << 20
_META = "nan_check"  # the key of an autograd node's metadata we set

_aten = torch.ops.aten
# ops whose outputs hold no computed values (uninitialized memory)
_UNWRITTEN = {_aten.empty.memory_format, _aten.empty_strided.default,
              _aten.new_empty.default, _aten.new_empty_strided.default,
              _aten.empty_like.default, _aten.resize_.default,
              _aten.set_.source_Storage_storage_offset}

ACTIVE = None  # the NanChecks recording now, if any
# each hand-written kernel's checked launches, over every NanChecks (a
# capture counts its recorded launches once; replays add nothing)
KERNEL_CHECKS = {}


def enabled():
    """Whether TERRAIN_CHECK_NANS asks for these checks (its "2")."""
    return os.environ.get("TERRAIN_CHECK_NANS") == "2"


def kernel_outputs(name, *outputs):
    """A hand-written kernel's outputs, checked under its name when checks
    are recording (called by each wrapper right after its launch)."""
    if ACTIVE is not None:
        ACTIVE.check_kernel(name, outputs)


def scope(net, path):
    """Names the ops run inside it (e.g. a network's optimizer update) when
    checks are recording; a no-op otherwise."""
    if ACTIVE is None:
        return contextlib.nullcontext()
    return ACTIVE.named(net, path)


def _tensors(value, out):
    if isinstance(value, torch.Tensor):
        out.append(value)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _tensors(v, out)
    return out


class _Mode(TorchDispatchMode):
    def __init__(self, checks):
        super().__init__()
        self.checks = checks

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _UNWRITTEN:
            return out
        found = _tensors(out, [])
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                _tensors(args[i] if i < len(args) else kwargs.get(a.name),
                         found)
        self.checks.check_op(func, found)
        return out


class NanChecks:
    """The flag buffer of one eager step or one chunk, and its table.

    `nets` maps a network name to its module.  Use `step(t, k)` around the
    t-th step of a chunk of k; then `hit()` (a device int32, nonzero when a
    NaN was flagged: the one value a mesh all-reduces) and, if it is,
    `raise_first()`.  `reset()` starts the table again for the next eager
    step."""

    def __init__(self, nets, device):
        self.names = {id(m): (net, path) for net, module in nets.items()
                      for path, m in module.named_modules()}
        self.flags = torch.zeros(CAPACITY, dtype=torch.bool, device=device)
        self.sites = []  # slot -> (step, k, network, module path, op)
        self._where = []  # the forward layers being called, innermost last
        self._stops = []  # their inputs' autograd nodes
        self._t, self._k = 0, 1

    def reset(self):
        self.sites.clear()

    @contextlib.contextmanager
    def step(self, t=0, k=1):
        """Records the checks of step t (from 0) of a chunk of k."""
        global ACTIVE
        if ACTIVE is not None:
            raise RuntimeError("NaN checks are already recording")
        self._t, self._k = t, k
        mod = torch.nn.modules.module
        hooks = (mod.register_module_forward_pre_hook(self._enter),
                 mod.register_module_forward_hook(self._leave))
        ACTIVE = self
        try:
            with _Mode(self):
                yield self
        finally:
            ACTIVE = None
            for h in hooks:
                h.remove()
            self._where.clear()
            self._stops.clear()

    @contextlib.contextmanager
    def named(self, net, path):
        self._where.append((net, path))
        try:
            yield
        finally:
            self._where.pop()

    # ------------------------------------------------------ module hooks
    def _enter(self, module, inputs):
        name = self.names.get(id(module))
        if name is None:
            return
        self._where.append(name)
        self._stops.append({id(t.grad_fn) for t in _tensors(inputs, [])
                            if t.grad_fn is not None})

    def _leave(self, module, inputs, output):
        name = self.names.get(id(module))
        if name is None:
            return
        self._where.pop()
        stops = self._stops.pop()
        # the autograd nodes this call made carry its layer for their
        # backward ops; an inner layer's, tagged first, keep theirs
        todo = [t.grad_fn for t in _tensors(output, [])
                if t.grad_fn is not None]
        seen = set()
        while todo:
            node = todo.pop()
            if node is None or id(node) in seen or id(node) in stops:
                continue
            seen.add(id(node))
            node.metadata.setdefault(_META, name)
            todo.extend(n for n, _ in node.next_functions)

    # ------------------------------------------------------------ checks
    def _place(self):
        """(network, module path, "forward" or the backward node's name)
        of the op being run now."""
        node = torch._C._current_autograd_node()
        if node is not None:
            net, path = node.metadata.get(_META, ("", ""))
            return net, path, f"backward, {node.name()}"
        if self._where:
            return (*self._where[-1], "forward")
        return "", "", "forward"

    def _record(self, tensors, label):
        net, path, phase = self._place()
        for i, t in enumerate(tensors):
            if not t.is_floating_point():
                continue
            slot = len(self.sites)
            if slot >= CAPACITY:
                raise RuntimeError(f"more than {CAPACITY} NaN checks in one "
                                   f"chunk")
            what = label if len(tensors) == 1 else f"{label} output {i}"
            self.sites.append((self._t, self._k, net, path,
                               f"{what} ({phase})"))
            torch.any(torch.isnan(t), out=self.flags[slot])

    def check_op(self, func, tensors):
        self._record(tensors, str(func))

    def check_kernel(self, name, tensors):
        KERNEL_CHECKS[name] = KERNEL_CHECKS.get(name, 0) + 1
        with torch.utils._python_dispatch._disable_current_modes():
            self._record(list(tensors), f"kernel {name}")

    # ------------------------------------------------------------- reads
    def hit(self):
        """A device int32 of shape (1,): nonzero when a slot is flagged."""
        return self.flags[:len(self.sites)].any().to(torch.int32).reshape(1)

    def raise_first(self):
        """Raises FloatingPointError naming the first flagged slot in
        program order, or, with none here, a NaN on another rank of the
        mesh (that rank names it)."""
        flagged = torch.nonzero(self.flags[:len(self.sites)])
        if flagged.numel() == 0:
            raise FloatingPointError(
                "NaN produced on another rank of the mesh (TERRAIN_CHECK_NANS"
                "=2): that rank raised naming the op")
        t, k, net, path, op = self.sites[int(flagged[0, 0])]
        where = f"{net} {path}".strip() or "the step outside the networks"
        raise FloatingPointError(
            f"NaN produced in step {t + 1} of {k} of the chunk (TERRAIN_CHECK"
            f"_NANS=2): {where}: {op}")
