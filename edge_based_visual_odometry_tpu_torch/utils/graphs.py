"""CUDA graphs around the pipeline's step callables.

On a CUDA device `build_stereo_step` and `build_temporal_step` hand the
body of their step to a `StepGraph`: everything after the host images
(and, supervised, the GT disparity and non-occlusion maps) reach the
card (float conversion, undistortion, Sobel, `detect_edges`,
`match_stereo`), and the temporal step whole (`match_temporal`,
`lift_quads`, `estimate_pose`), with the GT pose or without. The body
launches the same hand kernels and plain ops on either path; a graph
only takes away the host's launch of each one.

- The first call of a signature runs the body eagerly on the step's own
  capture stream, so that the caching allocator, cuBLAS and K5's texture
  maps (`descriptors._k5_maps`, one per stream) are set up there before
  any capture. The second call captures it into a `torch.cuda.CUDAGraph`
  and replays it, and every later call replays.
- A call copies its tensor arguments into the graph's static inputs
  (`StaticArgs`): a group of tensors that all view one storage, as the
  fields of an earlier step's result do, in one copy of the bytes they
  cover, any other tensor by itself.
- The captured body ends by writing its result into one flat byte arena
  (`Arena`); each replay returns one fresh copy of the arena whose views
  are the result's fields, so a result kept across calls never aliases
  memory a later replay writes.
- RANSAC's draws: the temporal step's graph owns one `torch.Generator`,
  registered with the graph and seeded with the call's seed before each
  replay, so that it draws what the eager step's fresh generator,
  seeded alike, draws.
- `cuda_build.LAUNCHES` advances on each replay by what the wrappers
  counted while the body was captured; `cuda_build.GRAPH_STEPS` counts
  each step's captures, replays and eager calls.
- A graph is captured and replayed only while every function of the
  modules its body runs through (`watched`: the stage functions, the
  K1-K9 wrappers, their dispatchers) is still the one the module
  defines: where one is rebound (a fault planted, a hook attached,
  before or after the step was built) the call runs eagerly, the same
  work launch for launch, and captures nothing, so the hook sees every
  launch. So does a call whose arguments differ in structure, shape,
  dtype or device from the captured call's.
"""

from __future__ import annotations

import contextlib

import torch

from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.utils.timing import span

ALIGN = 16      # bytes: where each field of an arena or a span starts


# ---- trees of tensors: NamedTuples and tuples of tensors, None kept ----
def flatten(tree):
    """(the tensors of `tree` in order, its structure for `unflatten`)."""
    leaves = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return len(leaves) - 1
        if isinstance(node, tuple):
            return type(node), [walk(c) for c in node]
        raise TypeError(f"a step's tree holds tensors, tuples and None, "
                        f"not {type(node).__name__}")
    return leaves, walk(tree)


def unflatten(spec, leaves):
    if spec is None:
        return None
    if isinstance(spec, int):
        return leaves[spec]
    kind, children = spec
    values = [unflatten(c, leaves) for c in children]
    return kind(*values) if hasattr(kind, "_fields") else kind(values)


def _spec_key(spec):
    """`spec` as a hashable value (NamedTuple types compare by identity)."""
    if spec is None or isinstance(spec, int):
        return spec
    return spec[0], tuple(_spec_key(c) for c in spec[1])


def signature(tree):
    """What a graph is captured for: the tree's structure and each
    tensor's dtype, shape and device."""
    leaves, spec = flatten(tree)
    return _spec_key(spec), tuple((t.dtype, tuple(t.shape), t.device)
                                  for t in leaves)


def _padded(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


class Arena:
    """Where each tensor of a tree lies in one flat uint8 buffer: whole
    and contiguous, each at a multiple of ALIGN bytes, in tree order."""

    def __init__(self, tree):
        leaves, self.spec = flatten(tree)
        self.fields = []                 # (dtype, shape, offset, nbytes)
        off = 0
        for t in leaves:
            n = t.numel() * t.element_size()
            self.fields.append((t.dtype, tuple(t.shape), off, n))
            off += _padded(n)
        self.nbytes = off

    def pack(self, tree, out: torch.Tensor):
        """Write `tree`'s tensors into `out` (uint8, `nbytes`) in one
        concatenation; the padding between fields is left as it is."""
        leaves, _ = flatten(tree)
        pad = torch.empty(ALIGN, dtype=torch.uint8, device=out.device)
        parts = []
        for t, (_, _, _, n) in zip(leaves, self.fields):
            if n:
                parts.append(t.reshape(-1).view(torch.uint8))
            if n % ALIGN:
                parts.append(pad[:ALIGN - n % ALIGN])
        torch.cat(parts, out=out)

    def unpack(self, buf: torch.Tensor):
        """The tree, each tensor a view of `buf` (uint8, `nbytes`)."""
        leaves = [buf[off:off + n].view(dtype).view(shape)
                  for dtype, shape, off, n in self.fields]
        return unflatten(self.spec, leaves)


def _byte_extent(t: torch.Tensor):
    """(first byte, one past the last byte) of `t` in its storage."""
    size = t.element_size()
    lo = t.storage_offset() * size
    if t.numel() == 0:
        return lo, lo
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return lo, lo + (last + 1) * size


def _shared_layout(leaves):
    """Where the tensors all view one storage: (its first byte rounded
    down to ALIGN, the bytes from there to the last, each tensor's
    (byte offset from the first, shape, stride, dtype)); else None."""
    if not leaves:
        return None
    ptr = leaves[0].untyped_storage().data_ptr()
    if any(t.untyped_storage().data_ptr() != ptr for t in leaves[1:]):
        return None
    ext = [_byte_extent(t) for t in leaves]
    lo = min(a for a, _ in ext) // ALIGN * ALIGN
    hi = max(b for _, b in ext)
    return lo, hi - lo, tuple((a - lo, tuple(t.shape), t.stride(), t.dtype)
                              for (a, _), t in zip(ext, leaves))


def _view(buf: torch.Tensor, offset: int, shape, stride, dtype):
    """A `dtype` view of the uint8 `buf` at byte `offset`."""
    return torch.empty(0, dtype=dtype, device=buf.device).set_(
        buf.untyped_storage(), offset // dtype.itemsize, shape, stride)


class StaticArgs:
    """A graph's static inputs: device tensors shaped as the capture
    call's arguments, in groups, into which each later call's arguments
    are copied. A group whose tensors all view one storage keeps their
    layout in one buffer and takes one copy of the bytes they cover
    wherever a call's group has the same layout; other tensors are
    copied one by one."""

    def __init__(self, groups, device):
        self.groups = []     # (spec, layout or None, buffer, static tensors)
        for g in groups:
            leaves, spec = flatten(g)
            layout = (_shared_layout(leaves)
                      if all(t.device == device for t in leaves) else None)
            buf = None
            if layout is None:
                static = [torch.empty(t.shape, dtype=t.dtype, device=device)
                          for t in leaves]
            else:
                buf = torch.empty(layout[1], dtype=torch.uint8,
                                  device=device)
                static = [_view(buf, *f) for f in layout[2]]
            self.groups.append((spec, layout, buf, static))

    def load(self, groups, around=None):
        """Copy `groups` (the capture call's signature) into the static
        tensors; returns them as trees. `around(i)`: a context around
        group i's copy."""
        out = []
        for i, (g, (spec, layout, buf, static)) in enumerate(
                zip(groups, self.groups)):
            leaves, _ = flatten(g)
            now = None if layout is None else _shared_layout(leaves)
            with contextlib.nullcontext() if around is None else around(i):
                if now is not None and now[1:] == layout[1:]:
                    buf.copy_(torch.empty(0, dtype=torch.uint8,
                                          device=buf.device).set_(
                        leaves[0].untyped_storage(), now[0], (now[1],)))
                else:
                    for s, t in zip(static, leaves):
                        s.copy_(t)
            out.append(unflatten(spec, static))
        return out


def capture_graph(fn, stream, generator=None):
    """A CUDA graph of what `fn()` launches, captured on `stream` in a
    pool of its own, with `generator`'s state registered with it."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return graph


def watched():
    """(module, name) of every function bound at a module-level name in
    the modules a step's body runs through: the stage functions, the
    K1-K9 wrappers, their dispatchers and helpers, each looked up at its
    module's name when called."""
    from edge_based_visual_odometry_tpu_torch import geometry
    from edge_based_visual_odometry_tpu_torch.models import (
        motion_tracker, stereo_matcher, temporal_matcher)
    from edge_based_visual_odometry_tpu_torch.ops import (
        clustering, descriptors, filters, gauss_newton, grid, image, patches,
        pose, tiled_sampling, toed)
    mods = (stereo_matcher, temporal_matcher, motion_tracker, geometry, toed,
            filters, image, grid, clustering, descriptors, patches,
            gauss_newton, pose, tiled_sampling)
    return tuple((m, n) for m in mods for n, v in sorted(vars(m).items())
                 if callable(v) and not isinstance(v, type))


def snapshot(names):
    """What each of `names` is bound to now, for `unchanged`."""
    return tuple((vars(m), n, getattr(m, n)) for m, n in names)


def unchanged(snap) -> bool:
    """Whether every name of `snap` is still bound as it was."""
    return all(d.get(n) is obj for d, n, obj in snap)


# the functions as the program's modules define them: a graph is captured
# and replayed only while every one is still bound at its name
PROGRAM = snapshot(watched())


class StepGraph:
    """One step callable's graph. `body(*groups, seed, generator)` is the
    step on device tensors: `groups` are trees of tensors, `seed` the
    call's RANSAC seed (or None), `generator` None on the eager path and
    the graph's own generator inside a capture. `load_spans`: for each
    of the first groups, the spans, outermost first, around its copy to
    the device (the stereo step's images and GT maps, which may lie on
    the host); a later group takes device tensors only, and a call with
    one of its tensors elsewhere runs eagerly. `generator`: the body
    draws from the graph's own generator. `name` is the step's entry of
    `cuda_build.GRAPH_STEPS`."""

    def __init__(self, name: str, body, device: torch.device,
                 load_spans=(), generator: bool = False):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.name, self.body, self.device = name, body, device
        self.load_spans = tuple(tuple(names) for names in load_spans)
        self.generator = (torch.Generator(device=device) if generator
                          else None)
        self.stream = None
        self.key = None          # the signature warmed up, then captured
        self.graph = None
        self.static = self.arena = self.out = self.launches = None

    def __call__(self, groups, seed=None):
        key = signature(tuple(groups))
        if (not unchanged(PROGRAM)
                or (self.graph is not None and key != self.key)
                or any(t.device != self.device
                       for g in groups[len(self.load_spans):]
                       for t in flatten(g)[0])):
            return self._eager(groups, seed)
        if self.graph is not None:
            return self._replay(groups, seed)
        if key != self.key:
            self.key = key
            return self._warm(groups, seed)
        return self._capture(groups, seed)

    def _count(self, what: str):
        CB.GRAPH_STEPS[self.name][what] += 1

    def _loading(self, i: int):
        """The load spans of group i, entered."""
        stack = contextlib.ExitStack()
        for name in self.load_spans[i] if i < len(self.load_spans) else ():
            stack.enter_context(span(name))
        return stack

    def _args(self, groups):
        """The eager body's arguments: copied to the device where the
        step takes host tensors, as they are where it does not."""
        out = list(groups)
        for i in range(min(len(out), len(self.load_spans))):
            leaves, spec = flatten(out[i])
            with self._loading(i):
                out[i] = unflatten(spec, [t.to(self.device) for t in leaves])
        return out

    def _eager(self, groups, seed):
        self._count("eager")
        return self.body(*self._args(groups), seed, None)

    def _warm(self, groups, seed):
        """The eager body on the capture stream, the device idle on both
        sides (no other stream's work overlaps the memory it reuses)."""
        self._count("eager")
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=self.device)
        args = self._args(groups)
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(self.stream):
            out = self.body(*args, seed, None)
        torch.cuda.synchronize(self.device)
        return out

    def _capture(self, groups, seed):
        self._count("capture")
        self.static = StaticArgs(groups, self.device)
        static = self.static.load(groups, self._loading)

        def body():
            tree = self.body(*static, seed, self.generator)
            self.arena = Arena(tree)
            self.out = torch.empty(self.arena.nbytes, dtype=torch.uint8,
                                   device=self.device)
            self.arena.pack(tree, self.out)

        before = dict(CB.LAUNCHES)
        self.graph = capture_graph(body, self.stream, self.generator)
        self.launches = {k: v - before[k] for k, v in CB.LAUNCHES.items()
                         if v != before[k]}
        return self._run(seed)

    def _replay(self, groups, seed):
        self._count("replay")
        self.static.load(groups, self._loading)
        for k, v in self.launches.items():
            CB.LAUNCHES[k] += v
        return self._run(seed)

    def _run(self, seed):
        with span("graph.replay"):
            if self.generator is not None:
                self.generator.manual_seed(int(seed))
            self.graph.replay()
            return self.arena.unpack(self.out.clone())
