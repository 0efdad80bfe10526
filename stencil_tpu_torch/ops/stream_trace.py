"""Trace a user step kernel once into an expression graph, and run the graph.

The JAX package traces a Python ``kernel(views, info)`` straight into the
Pallas body of its stream kernels (``PlaneView``/``PlaneInfo``,
``stencil_tpu/ops/stream.py:145-224``).  PyTorch runs eagerly and CUDA is
compiled ahead of the call, so the port traces the kernel ONCE over symbolic
views into a graph of ``Node``s and has two back ends for it:

* ``evaluate``: a torch evaluator over whole planes, blocks or stacks.  It is
  the plain version of every stream kernel, and the torch engine of
  ``DistributedDomain.make_step`` runs user kernels through it too, so both
  engines share one arithmetic;
* ``emit_cuda``: a ``__device__`` body for the kernel templates in
  ``csrc/stream_*.cu``, and the macro that picks the wavefront kernel's
  register-queue form for kernels that read x-1 and x+1 only at the
  centre (``x_reads_centred``).

What a traced kernel may do: ``views[name].sh(dx, dy, dz)`` (every offset
within the declared ``x_radius``, as ``stream.py:179-181`` asserts) and
``center()``; ``info.coords()`` (the wrapped global x, y, z as int32),
``info.global_size`` and ``info.level``; ``+ - * /``, unary minus, ``**``
with an integer exponent, comparisons, ``& | ~`` on masks, ``abs``,
``.to(dtype)``/``.astype(dtype)`` and ``torch.where``.  Anything else raises
``TypeError`` at trace time and names the op: there is no eager fallback.

Component (N-D) quantities, on the torch engine only: a traced value carries
the shape of its leading component dims (``comps``; a ``(3,)`` vector's reads
are ``(3,)``, scalars and numbers ``()``), which broadcast as the tensors'
leading dims do.  Such a kernel may take a component with an integer index
(``v.sh(1, 0, 0)[0]``) and build a vector with ``torch.stack(values,
dim=0)``, as a JAX kernel does with ``jnp``; each output must broadcast to its
field's components.  The stream engine's kernels take neither (its traces
have no components, and ``emit_cuda`` refuses both ops, naming them).

The arithmetic contract, chosen so the port matches XLA's compiled JAX:

* evaluation follows Python's order, with no reassociation;
* Python numbers are weakly typed: float32 beside a float32 value, int32
  beside an int32 value;
* ``x / c`` with ``c`` a Python number is ``x * float32(1 / c)``, as XLA
  compiles a division by a constant; a division by a traced value stays an
  IEEE divide; integer true division is refused;
* ``x ** n`` is the square-and-multiply chain of ``lax.integer_pow``;
* the CUDA body calls ``__fadd_rn``/``__fmul_rn``/``__fsub_rn``/``__fdiv_rn``
  so nvcc cannot contract a multiply and an add, and the torch evaluator runs
  one op per node: kernel and plain version are bitwise equal on the card.

XLA on the CPU also contracts ``a * b + c`` into one fused multiply-add.  The
port does NOT reproduce that: a kernel with a multiply feeding an add (the
variable-coefficient diffusion of ``tests/test_stream.py``) agrees with the
JAX package to ``rtol=1e-6, atol=1e-6`` (the tolerance of
``tests/test_stream.py:26``), not bitwise.  Mean-of-6 kernels (Astaroth,
Jacobi), and weighted sums whose weights are powers of two, have no inexact
product feeding an add and are bitwise.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.dim3 import Dim3

F32, I32, BOOL = "f32", "i32", "bool"
_TORCH_DTYPE = {F32: torch.float32, I32: torch.int32, BOOL: torch.bool}
_C_TYPE = {F32: "float", I32: "int", BOOL: "bool"}
_ARITH = ("add", "sub", "mul", "div")
_COMPARE = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}


def _kind_of_dtype(dtype) -> str:
    """The graph's value kind of a torch/numpy dtype or dtype name."""
    if isinstance(dtype, str):
        dtype = np.dtype(dtype)
    if isinstance(dtype, torch.dtype):
        table = {torch.float32: F32, torch.int32: I32, torch.bool: BOOL}
    else:
        dtype = np.dtype(dtype)
        table = {np.dtype(np.float32): F32, np.dtype(np.int32): I32, np.dtype(np.bool_): BOOL}
    if dtype not in table:
        raise TypeError(f"traced kernels compute in float32, int32 and bool; got dtype {dtype}")
    return table[dtype]


def _number(v):
    """A Python or numpy scalar as a Python number, else None."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    return None


def _broadcast_comps(*shapes: tuple) -> tuple:
    """The component shape of values of these component shapes combined."""
    try:
        return tuple(np.broadcast_shapes(*shapes))
    except ValueError:
        raise ValueError(f"component shapes {shapes} do not broadcast") from None


class Graph:
    """The nodes of one trace, in creation order (a topological order).
    ``components`` holds each field's component shape (None: a stream
    kernel's trace, which takes no component ops)."""

    def __init__(self, components: Optional[Sequence[tuple]] = None):
        self.components = None if components is None else [tuple(c) for c in components]
        self.nodes: List[Node] = []
        self._consts: Dict[tuple, Node] = {}
        self._loads: Dict[tuple, Node] = {}
        self.reads_level = False

    def load(self, q: int, d: Tuple[int, int, int]) -> "Node":
        """Field ``q`` at offset ``d``: one node per distinct read."""
        key = (q,) + tuple(d)
        node = self._loads.get(key)
        if node is None:
            comps = self.components[q] if self.components is not None else ()
            node = self._loads[key] = Node(self, "load", key, F32, comps)
        return node

    def takes_components(self, op: str) -> None:
        """Refuse a component op in a stream kernel's trace."""
        if self.components is None:
            raise TypeError(f"{op} is not supported in traced stream kernels (the torch engine "
                            "takes it on component quantities)")

    def const(self, value, kind: str) -> "Node":
        if kind == F32:
            value = float(np.float32(value))
            key = (kind, np.float32(value).tobytes())
        elif kind == I32:
            value = int(np.int32(value))
            key = (kind, value)
        else:
            value = bool(value)
            key = (kind, value)
        node = self._consts.get(key)
        if node is None:
            node = self._consts[key] = Node(self, "const", (value,), kind)
        return node


class Node:
    """One traced value.  Operators build new nodes; nothing is computed.
    ``comps`` is the shape of its leading component dims (by default the
    broadcast of its operands')."""

    __slots__ = ("graph", "op", "args", "kind", "idx", "comps")
    __hash__ = object.__hash__
    __array_ufunc__ = None  # numpy scalars defer to the reflected operators

    def __init__(self, graph: Graph, op: str, args: tuple, kind: str, comps: Optional[tuple] = None):
        self.graph, self.op, self.args, self.kind = graph, op, args, kind
        self.comps = comps if comps is not None else _broadcast_comps(
            *(a.comps for a in args if isinstance(a, Node)))
        self.idx = len(graph.nodes)
        graph.nodes.append(self)

    # --- dtype ------------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return _TORCH_DTYPE[self.kind]

    def to(self, dtype, *args, **kwargs) -> "Node":
        if args or kwargs:
            raise TypeError("traced kernels support .to(dtype) only")
        return _cast(self, _kind_of_dtype(dtype))

    astype = to

    # --- arithmetic -------------------------------------------------------
    def __add__(self, o):
        return _binary("add", self, o)

    def __radd__(self, o):
        return _binary("add", o, self)

    def __sub__(self, o):
        return _binary("sub", self, o)

    def __rsub__(self, o):
        return _binary("sub", o, self)

    def __mul__(self, o):
        return _binary("mul", self, o)

    def __rmul__(self, o):
        return _binary("mul", o, self)

    def __truediv__(self, o):
        return _binary("div", self, o)

    def __rtruediv__(self, o):
        return _binary("div", o, self)

    def __neg__(self):
        if self.kind == BOOL:
            raise TypeError("unary minus of a mask is not supported in traced kernels")
        return Node(self.graph, "neg", (self,), self.kind)

    def __pos__(self):
        return self

    def __abs__(self):
        if self.kind == BOOL:
            raise TypeError("abs of a mask is not supported in traced kernels")
        return Node(self.graph, "abs", (self,), self.kind)

    def __pow__(self, e):
        return _integer_pow(self, e)

    def __rpow__(self, o):
        raise TypeError("'number ** traced value' is not supported in traced kernels")

    # --- comparisons and masks ---------------------------------------------
    def __lt__(self, o):
        return _binary("lt", self, o)

    def __le__(self, o):
        return _binary("le", self, o)

    def __gt__(self, o):
        return _binary("gt", self, o)

    def __ge__(self, o):
        return _binary("ge", self, o)

    def __eq__(self, o):  # noqa: D105 - builds a mask, as a tensor's == does
        return _binary("eq", self, o)

    def __ne__(self, o):
        return _binary("ne", self, o)

    def __and__(self, o):
        return _logical("and", self, o)

    __rand__ = __and__

    def __or__(self, o):
        return _logical("or", self, o)

    __ror__ = __or__

    def __invert__(self):
        if self.kind != BOOL:
            raise TypeError("~ applies to masks only in traced kernels")
        return Node(self.graph, "not", (self,), BOOL)

    # --- components -----------------------------------------------------------
    def __getitem__(self, i):
        """Component ``i`` of the leading component dim (an integer index)."""
        self.graph.takes_components("indexing")
        if isinstance(i, (bool, np.bool_)) or not isinstance(i, (int, np.integer)):
            raise TypeError(f"a traced value takes an integer component index only, got {i!r}")
        if not self.comps:
            raise TypeError("indexing a traced value that has no component dims")
        c = self.comps[0]
        if not -c <= int(i) < c:
            raise IndexError(f"component {i} of {c}")
        return Node(self.graph, "index", (self, int(i) % c), self.kind, self.comps[1:])

    # --- refused ------------------------------------------------------------
    def __bool__(self):
        raise TypeError(
            "a traced kernel cannot branch on a traced value (bool()); use torch.where"
        )

    def _refuse(name):  # noqa: N805 - builds the refusing methods below
        def refuse(self, *args, **kwargs):
            raise TypeError(f"operator {name!r} is not supported in traced stream kernels")

        return refuse

    __floordiv__ = __rfloordiv__ = _refuse("//")
    __mod__ = __rmod__ = _refuse("%")
    __matmul__ = __rmatmul__ = _refuse("@")
    __float__ = _refuse("float()")
    __int__ = _refuse("int()")
    __index__ = _refuse("index")
    __len__ = _refuse("len()")
    __iter__ = _refuse("iteration")
    __xor__ = __rxor__ = _refuse("^")
    __lshift__ = __rshift__ = _refuse("shift")
    del _refuse

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise TypeError(f"{name!r} is not supported in traced stream kernels")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if func in (torch.where, torch.Tensor.where) and not kwargs:
            if len(args) != 3:
                raise TypeError("torch.where in a traced kernel takes (condition, a, b)")
            return where(*args)
        if func in (torch.abs, torch.Tensor.abs) and len(args) == 1 and not kwargs:
            return abs(args[0])
        if func is torch.stack and len(args) + len(kwargs) <= 2 and set(kwargs) <= {"dim"}:
            dim = args[1] if len(args) == 2 else kwargs.get("dim", 0)
            return stack(args[0], dim)
        raise TypeError(
            f"torch.{name} is not supported in traced stream kernels (supported: + - * / "
            "unary -, ** int, comparisons, & | ~, abs, .to(dtype), torch.where; on components "
            "[i] and torch.stack(..., dim=0))"
        )

    def __repr__(self):
        return f"Node({self.op}, {self.kind}, #{self.idx})"


def _graph_of(*vals) -> Graph:
    for v in vals:
        if isinstance(v, Node):
            return v.graph
    raise TypeError("no traced value among the operands")


def _operand(v):
    if isinstance(v, Node):
        return v
    n = _number(v)
    if n is None:
        what = "a tensor" if isinstance(v, torch.Tensor) else type(v).__name__
        raise TypeError(
            f"a traced kernel combines traced values with Python numbers only, got {what}"
        )
    return n


def _cast(v: Node, kind: str) -> Node:
    if v.kind == kind:
        return v
    return Node(v.graph, "cast", (v,), kind)


def _const_kind(c, other: str) -> str:
    """The weak type of a Python number beside a value of kind ``other``."""
    if isinstance(c, bool):
        return BOOL if other == BOOL else I32
    if isinstance(c, int):
        return F32 if other == F32 else I32
    return F32


def _promote(a, b):
    """Both operands as nodes of one kind (float32 > int32 > bool)."""
    g = _graph_of(a, b)
    a, b = _operand(a), _operand(b)
    if not isinstance(a, Node):
        k = _const_kind(a, b.kind)
        b = _cast(b, _wider(k, b.kind))
        a = g.const(a, b.kind)
    elif not isinstance(b, Node):
        k = _const_kind(b, a.kind)
        a = _cast(a, _wider(k, a.kind))
        b = g.const(b, a.kind)
    else:
        k = _wider(a.kind, b.kind)
        a, b = _cast(a, k), _cast(b, k)
    return a, b


def _wider(a: str, b: str) -> str:
    order = {BOOL: 0, I32: 1, F32: 2}
    return a if order[a] >= order[b] else b


def _binary(op: str, a, b) -> Node:
    g = _graph_of(a, b)
    if op == "div":
        if isinstance(b, Node) or _number(b) is None:
            a, b = _promote(a, b)
            if a.kind != F32:
                raise TypeError("integer true division is not supported in traced kernels")
            return Node(g, "div", (a, b), F32)
        # XLA compiles a division by a constant as a multiply by the float32
        # reciprocal; so does the port
        a, c = _operand(a), _number(b)
        if a.kind != F32:
            if not isinstance(c, float):
                raise TypeError("integer true division is not supported in traced kernels")
            a = _cast(a, F32)
        if c == 0:
            return Node(g, "div", (a, g.const(c, F32)), F32)
        recip = np.float32(1.0) / np.float32(c)
        return Node(g, "mul", (a, g.const(float(recip), F32)), F32)
    a, b = _promote(a, b)
    if op in _ARITH:
        if a.kind == BOOL:
            a, b = _cast(a, I32), _cast(b, I32)
        return Node(g, op, (a, b), a.kind)
    return Node(g, op, (a, b), BOOL)


def _logical(op: str, a, b) -> Node:
    a, b = _promote(a, b)
    if a.kind != BOOL:
        raise TypeError(f"'{'&' if op == 'and' else '|'}' applies to masks only in traced kernels")
    return Node(a.graph, op, (a, b), BOOL)


def _integer_pow(x: Node, e) -> Node:
    """``lax.integer_pow``'s square-and-multiply chain."""
    if isinstance(e, bool) or _number(e) is None or not isinstance(_number(e), int):
        raise TypeError("traced kernels support ** with a Python int exponent only")
    e = int(e)
    if x.kind == BOOL:
        x = _cast(x, I32)
    if e == 0:
        return x.graph.const(1, x.kind)
    recip = e < 0
    if recip and x.kind != F32:
        raise TypeError("a negative integer power of an int value is not supported")
    e = abs(e)
    acc = None
    while e > 0:
        if e & 1:
            acc = x if acc is None else acc * x
        e >>= 1
        if e > 0:
            x = x * x
    return Node(acc.graph, "div", (acc.graph.const(1.0, F32), acc), F32) if recip else acc


def where(cond, a, b) -> Node:
    """``torch.where`` / ``jnp.where`` on traced values."""
    g = _graph_of(cond, a, b)
    if not isinstance(cond, Node) or cond.kind != BOOL:
        raise TypeError("the condition of torch.where in a traced kernel must be a traced mask")
    if not isinstance(a, Node) and not isinstance(b, Node):
        ka = _const_kind(_operand(a), F32)
        kb = _const_kind(_operand(b), F32)
        k = _wider(ka, kb)
        a, b = g.const(a, k), g.const(b, k)
    else:
        a, b = _promote(a, b)
    return Node(g, "where", (cond, a, b), a.kind)


def stack(values, dim: int = 0) -> Node:
    """``torch.stack(values, dim=0)`` / ``jnp.stack`` on traced values: a new
    leading component dim of ``len(values)``."""
    values = list(values)
    if not values:
        raise ValueError("torch.stack of no values")
    g = _graph_of(*values)
    g.takes_components("torch.stack")
    if dim != 0:
        raise TypeError(f"traced kernels stack along a new leading component dim (dim=0), not dim={dim}")
    nodes = [v for v in values if isinstance(v, Node)]
    kind = F32 if any(_number(v) is not None and isinstance(_number(v), float) for v in values) else None
    for v in nodes:
        kind = v.kind if kind is None else _wider(kind, v.kind)
    args = tuple(_cast(v, kind) if isinstance(v, Node) else g.const(_operand(v), kind) for v in values)
    inner = _broadcast_comps(*(a.comps for a in args))
    return Node(g, "stack", args, kind, (len(args),) + inner)


# --- the symbolic views ---------------------------------------------------------


class PlaneView:
    """A quantity inside a traced stream kernel: ``sh(dx, dy, dz)`` is the
    reference's ``src[o + Dim3(dx, dy, dz)]`` accessor read
    (accessor.hpp:27-40).  Every offset must lie within ``x_radius``, the
    kernel's declared read distance (``stream.py:179-181``): a wider in-plane
    read would wrap opposite-edge values into cells counted as valid."""

    def __init__(self, graph: Graph, q: int, radius: Optional[int]):
        self._graph, self._q, self._r = graph, q, radius

    def sh(self, dx: int = 0, dy: int = 0, dz: int = 0) -> Node:
        d = tuple(int(v) for v in (dx, dy, dz))
        if self._r is not None and not all(-self._r <= v <= self._r for v in d):
            raise ValueError(f"shift {d} exceeds the kernel's declared x_radius {self._r}")
        return self._graph.load(self._q, d)

    def center(self) -> Node:
        return self.sh(0, 0, 0)


class PlaneInfo:
    """Per-level context of a traced stream kernel: ``coords()`` gives the
    wrapped global x, y, z of the cell as int32 values; ``global_size`` and
    ``level`` (1-based) are Python values.  Further static attributes (the
    torch engine's ``interior``, ``radius``, ``region``) pass through."""

    def __init__(self, graph: Graph, global_size: Dim3, level: int, extra: Optional[dict] = None):
        self._graph = graph
        self.global_size = global_size
        self._level = level
        self._coords = tuple(Node(graph, "coord", (ax,), I32) for ax in range(3))
        for k, v in (extra or {}).items():
            setattr(self, k, v)

    @property
    def level(self) -> int:
        self._graph.reads_level = True
        return self._level

    def coords(self) -> Tuple[Node, Node, Node]:
        return self._coords


# --- a traced kernel ------------------------------------------------------------


class Trace:
    """One level's graph and its outputs, one per field (``None``: the field
    passes through unchanged)."""

    def __init__(self, graph: Graph, outputs: List[Optional[Node]]):
        self.graph = graph
        self.outputs = outputs

    def live(self) -> List[Node]:
        """The nodes the outputs depend on, in creation order."""
        seen = set()
        stack = [o for o in self.outputs if o is not None]
        while stack:
            n = stack.pop()
            if n.idx in seen:
                continue
            seen.add(n.idx)
            stack.extend(a for a in n.args if isinstance(a, Node))
        return [n for n in self.graph.nodes if n.idx in seen]


class StreamKernel:
    """A user kernel ``(views, info) -> {name: values}`` traced for one set of
    field names: what every stream kernel wrapper and the torch engine run.
    ``x_radius`` bounds the shifts (None: unbounded, the torch engine's
    shell-carrying views check their own extent); ``info_extra`` adds static
    attributes to the traced ``info``.  Traces are made per level on first
    use, and shared by all levels when the kernel never reads
    ``info.level``."""

    def __init__(self, kernel: Callable, names: Sequence[str], x_radius: Optional[int],
                 global_size, info_extra: Optional[dict] = None,
                 components: Optional[Sequence[tuple]] = None):
        self.kernel = kernel
        self.names = list(names)
        #: each field's component shape; None for a stream kernel (no
        #: component ops), else the torch engine's quantities
        self.components = None if components is None else [tuple(c) for c in components]
        self.x_radius = x_radius
        self.global_size = global_size if isinstance(global_size, Dim3) else Dim3(*global_size)
        self._extra = info_extra
        self._traces: Dict[int, Trace] = {}
        self._level_free: Optional[Trace] = None
        #: memo of the back ends (the generated CUDA sources), keyed by them
        self.cache: dict = {}

    def trace(self, level: int = 1) -> Trace:
        if self._level_free is not None:
            return self._level_free
        t = self._traces.get(level)
        if t is None:
            g = Graph(self.components)
            views = {n: PlaneView(g, q, self.x_radius) for q, n in enumerate(self.names)}
            out = self.kernel(views, PlaneInfo(g, self.global_size, level, self._extra))
            if not isinstance(out, dict):
                raise TypeError(f"a stream kernel returns {{name: values}}, got {type(out).__name__}")
            outputs = []
            for q, n in enumerate(self.names):
                v = out.get(n)
                if v is None:
                    outputs.append(None)
                    continue
                v = v if isinstance(v, Node) else g.const(_operand(v), F32)
                want = g.components[q] if g.components is not None else ()
                if _broadcast_comps(v.comps, want) != want:
                    raise ValueError(f"the kernel's value for {n!r} has components {v.comps}, "
                                     f"which do not broadcast to the field's {want}")
                outputs.append(_cast(v, F32))
            t = self._traces[level] = Trace(g, outputs)
            if not g.reads_level:
                self._level_free = t
        return t

    def updates(self) -> List[bool]:
        """Which fields the kernel writes (the others pass through)."""
        return [o is not None for o in self.trace(1).outputs]

    def evaluate(self, load: Callable, coords: Callable, device, level: int = 1) -> List[torch.Tensor]:
        """Run one level with torch: ``load(q, dx, dy, dz)`` returns field
        ``q`` shifted by the offset, ``coords()`` the broadcastable int32
        global x, y, z.  Returns one tensor per field; a pass-through field
        gives ``load(q, 0, 0, 0)``."""
        t = self.trace(level)
        live = t.live()
        last = {a.idx: i for i, n in enumerate(live) for a in n.args if isinstance(a, Node)}
        keep = {o.idx for o in t.outputs if o is not None}
        vals: Dict[int, torch.Tensor] = {}
        xyz = None
        for i, n in enumerate(live):
            if n.op == "load":
                v = load(*n.args)
            elif n.op == "coord":
                if xyz is None:
                    xyz = tuple(c.to(torch.int32) for c in coords())
                v = xyz[n.args[0]]
            elif n.op == "const":
                # a fill on the device, not a host-to-device copy (a captured
                # step may hold no copy from the host)
                v = torch.full((), n.args[0], dtype=_TORCH_DTYPE[n.kind], device=device)
            else:
                v = _TORCH_OPS[n.op](*(vals[a.idx] for a in n.args if isinstance(a, Node)), n)
            vals[n.idx] = v
            for a in n.args:  # free what no later node reads (the card's memory)
                if isinstance(a, Node) and last[a.idx] == i and a.idx not in keep:
                    vals.pop(a.idx, None)
        return [load(q, 0, 0, 0) if o is None else vals[o.idx] for q, o in enumerate(t.outputs)]

    def cuda_body(self, levels: Sequence[int]) -> str:
        """The ``stp_body`` device function for the kernel templates, for the
        given levels (one body when the kernel never reads its level)."""
        first = self.trace(levels[0])
        if self._level_free is first:
            return emit_cuda({None: first}, len(self.names))
        return emit_cuda({lv: self.trace(lv) for lv in levels}, len(self.names))


_TORCH_OPS = {
    "add": lambda a, b, n: a + b,
    "sub": lambda a, b, n: a - b,
    "mul": lambda a, b, n: a * b,
    "div": lambda a, b, n: torch.div(a, b),
    "neg": lambda a, n: -a,
    "abs": lambda a, n: torch.abs(a),
    "lt": lambda a, b, n: a < b,
    "le": lambda a, b, n: a <= b,
    "gt": lambda a, b, n: a > b,
    "ge": lambda a, b, n: a >= b,
    "eq": lambda a, b, n: a == b,
    "ne": lambda a, b, n: a != b,
    "and": lambda a, b, n: a & b,
    "or": lambda a, b, n: a | b,
    "not": lambda a, n: ~a,
    "where": lambda c, a, b, n: torch.where(c, a, b),
    "cast": lambda a, n: a.to(_TORCH_DTYPE[n.kind]),
    "index": lambda a, n: a[n.args[1]],
}


def _stacked(n: Node, *vals: torch.Tensor) -> torch.Tensor:
    """The torch engine's ``stack``: each value as a ``(*comps, px, py, pz,
    nx, ny, nz)``-ranked tensor (a number or a coordinate gains leading
    ones, as it broadcasts), broadcast together and stacked."""
    rank = 6 + len(n.comps) - 1
    vals = [v.reshape((1,) * (rank - v.dim()) + tuple(v.shape)) for v in vals]
    return torch.stack(torch.broadcast_tensors(*vals), dim=0)


_TORCH_OPS["stack"] = lambda *a: _stacked(a[-1], *a[:-1])


# --- the CUDA emitter ---------------------------------------------------------


def _c_float(v: float) -> str:
    if math.isnan(v):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(v):
        return "__int_as_float(0x7f800000)" if v > 0 else "__int_as_float(0xff800000)"
    return float.hex(float(np.float32(v))) + "f"


def _c_const(n: Node) -> str:
    v = n.args[0]
    if n.kind == F32:
        return _c_float(v)
    if n.kind == I32:
        return f"({v})" if v > -(2 ** 31) else "(-2147483647 - 1)"
    return "true" if v else "false"


def _c_expr(n: Node) -> str:
    a = [f"t{x.idx}" for x in n.args if isinstance(x, Node)]
    op, k = n.op, n.kind
    if op in ("index", "stack"):
        raise TypeError(f"the CUDA stream kernels take no component ops; {op!r} is the torch "
                        "engine's (make_step(engine='torch'))")
    if op == "load":
        q, dx, dy, dz = n.args
        return f"ld({q}, {dx}, {dy}, {dz})"
    if op == "coord":
        return ("xg", "yg", "zg")[n.args[0]]
    if op == "const":
        return _c_const(n)
    if op in _ARITH:
        if k == F32:
            return f"__f{op}_rn({a[0]}, {a[1]})"
        sym = {"add": "+", "sub": "-", "mul": "*"}[op]
        return f"(int)((unsigned){a[0]} {sym} (unsigned){a[1]})"  # int32 wraps, as XLA's
    if op == "neg":
        return f"(-{a[0]})" if k == F32 else f"(int)(0u - (unsigned){a[0]})"
    if op == "abs":
        return f"fabsf({a[0]})" if k == F32 else f"abs({a[0]})"
    if op in _COMPARE:
        return f"({a[0]} {_COMPARE[op]} {a[1]})"
    if op == "and":
        return f"({a[0]} && {a[1]})"
    if op == "or":
        return f"({a[0]} || {a[1]})"
    if op == "not":
        return f"(!{a[0]})"
    if op == "where":
        return f"({a[0]} ? {a[1]} : {a[2]})"
    if op == "cast":
        src = n.args[0].kind
        if k == F32:
            return f"__int2float_rn({a[0]})" if src == I32 else f"({a[0]} ? 1.0f : 0.0f)"
        if k == I32:
            return f"__float2int_rz({a[0]})" if src == F32 else f"({a[0]} ? 1 : 0)"
        return f"({a[0]} != 0.0f)" if src == F32 else f"({a[0]} != 0)"
    raise AssertionError(op)


def _emit_level(t: Trace, indent: str) -> List[str]:
    lines = []
    for n in t.live():
        lines.append(f"{indent}const {_C_TYPE[n.kind]} t{n.idx} = {_c_expr(n)};")
    for q, o in enumerate(t.outputs):
        val = f"ld({q}, 0, 0, 0)" if o is None else f"t{o.idx}"
        lines.append(f"{indent}out[{q}] = {val};")
    return lines


def x_reads_centred(traces: Iterable[Trace]) -> bool:
    """Does every read at x-1 or x+1 of these traces sit at in-plane offset
    (0, 0)?  Then the wavefront kernel keeps a cell's x neighbours in
    registers (its register-queue form, ``csrc/stream_wavefront.cu``)."""
    return all(n.args[1] == 0 or n.args[2:] == (0, 0)
               for t in traces for n in t.live() if n.op == "load")


def emit_cuda(traces: Dict[Optional[int], Trace], n_fields: int) -> str:
    """The generated part of a kernel template: the field count,
    ``STP_X_QUEUE`` where ``x_reads_centred`` holds, and ``stp_body(ld,
    level, xg, yg, zg, out)``, which reads field ``q`` at an offset through
    ``ld(q, dx, dy, dz)`` and writes every field's new value (a pass-through
    field its centre) to ``out``.  ``traces`` maps a level to its trace, or
    ``None`` to the one trace of a level-free kernel."""
    lines = [f"#define STP_NF {n_fields}"]
    if x_reads_centred(traces.values()):
        lines.append("#define STP_X_QUEUE 1")
    lines += [
        "template <class Ld>",
        "__device__ __forceinline__ void stp_body(const Ld& ld, int level, int xg, int yg, int zg,",
        "                                         float (&out)[STP_NF]) {",
        "  (void)level; (void)xg; (void)yg; (void)zg;",
    ]
    if None in traces:
        lines += _emit_level(traces[None], "  ")
    else:
        for j, (lv, t) in enumerate(sorted(traces.items())):
            lines.append(f"  {'if' if j == 0 else '} else if'} (level == {lv}) {{")
            lines += _emit_level(t, "    ")
        lines.append("  } else {")
        lines += [f"    out[{q}] = __int_as_float(0x7fc00000);" for q in range(n_fields)]
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"


def run_kernel(kernel: Callable, views: Dict[str, object], info=None) -> Dict[str, torch.Tensor]:
    """Evaluate ``kernel`` once through the trace over eager views that have
    ``sh(dx, dy, dz)`` (the torch engine's ``ShardView``s), with the torch
    engine's arithmetic: what a reference-style loop (exchange, compute,
    swap) calls.  ``info`` gives ``coords()`` and ``global_size`` (None: the
    kernel reads neither)."""
    names = list(views)
    gsize = info.global_size if info is not None else Dim3(0, 0, 0)
    static = {k: getattr(info, k) for k in ("interior", "radius", "region") if hasattr(info, k)}
    sk = StreamKernel(kernel, names, None, gsize, static)
    device = views[names[0]].sh(0, 0, 0).device
    vals = sk.evaluate(lambda q, dx, dy, dz: views[names[q]].sh(dx, dy, dz),
                       info.coords if info is not None else None, device)
    return {n: v for n, v, w in zip(names, vals, sk.updates()) if w}


__all__ = [
    "Graph", "Node", "PlaneInfo", "PlaneView", "StreamKernel", "Trace", "emit_cuda",
    "run_kernel", "where", "x_reads_centred",
]
