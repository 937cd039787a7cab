"""High-level propagation entry points (PyTorch port of
:mod:`quantumpropagators.propagate`; reference ``src/propagate.jl``).

``propagate(state, generator, tlist, method=...)`` validates inputs,
initializes a propagator, and runs the outer time loop with optional
observable storage and per-step callbacks.  ``fused=True`` runs the
whole grid through :func:`~.fused.cheby_propagate_fused` (or, with
``method="newton_leja"``, :func:`~.ops.newton_leja.newton_leja_propagate_dd`)
instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np

from .propagators.base import Propagator, init_prop
from .storage import (
    _StoreState,
    init_storage,
    map_observables,
    write_to_storage,
)

__all__ = ["propagate", "propagate_sequence", "Propagation"]


def propagate(
    state,
    generator=None,
    tlist=None,
    *,
    method: str = "auto",
    check: bool = True,
    backward: bool = False,
    verbose: bool = False,
    storage=None,
    observables=None,
    callback: Optional[Callable] = None,
    show_progress: bool = False,
    propagator: Optional[Propagator] = None,
    fused: bool = False,
    _return_both: bool = False,
    **kwargs,
):
    """Propagate ``state`` under ``generator`` over the time grid
    ``tlist``.

    Simulates the dynamics interval by interval (piecewise-constant by
    default), mirroring reference ``src/propagate.jl:167-235``:

    - ``storage=True``: allocate storage for the ``observables``
      (default: the state itself) at every grid point and *return the
      storage*; pass a pre-allocated array to fill it instead.
    - ``observables``: tuple of operators (→ expectation values) and/or
      functions of the state.
    - ``callback(propagator, observables)`` runs after every step.
    - ``backward=True`` propagates from ``tlist[-1]`` to ``tlist[0]``
      (storage filled back-to-front).
    - ``fused=True`` (``method`` ``"cheby"`` or ``"newton_leja"``): run
      the whole time grid through :func:`~.fused.cheby_propagate_fused`
      (the hand-written flip kernels where the generator has
      diagonal-plus-site-flip structure) or, for ``"newton_leja"``,
      :func:`~.ops.newton_leja.newton_leja_propagate_dd` (complex128).
      Observables must then be functions of the state tensor (or
      operators → expectation values); host callbacks are unsupported.
      On the card the grid is one replayed CUDA graph
      (:mod:`.utils.scan`), so a function observable must return a
      device tensor without reading the host (no ``.item()``,
      ``float(t)`` or ``.cpu()``): one that does raises.

    Returns the final state, or the storage if ``storage=True``.
    """
    if fused:
        return _propagate_fused(
            state,
            generator,
            tlist,
            method=method,
            backward=backward,
            storage=storage,
            observables=observables,
            callback=callback,
            _return_both=_return_both,
            **kwargs,
        )
    if propagator is None:
        if generator is None or tlist is None:
            raise ValueError("propagate requires (state, generator, tlist)")
        if check:
            from .interfaces import check_generator, check_state, check_tlist

            tl = np.asarray(tlist, dtype=np.float64)
            if not check_tlist(tl):
                raise ValueError("`tlist` does not pass check_tlist")
            if not check_state(state, quiet=True):
                raise ValueError("`state` does not pass check_state")
            if not check_generator(
                generator, state=state, tlist=tl, quiet=True
            ):
                raise ValueError("`generator` does not pass check_generator")
        propagator = init_prop(
            state, generator, tlist, method=method, backward=backward, **kwargs
        )
    else:
        from .propagators.base import reinit_prop

        reinit_prop(propagator, state, **kwargs)
    return propagate_propagator(
        propagator,
        storage=storage,
        observables=observables,
        callback=callback,
        show_progress=show_progress,
        _return_both=_return_both,
    )


def _propagate_fused(
    state,
    generator,
    tlist,
    *,
    method,
    backward,
    storage,
    observables,
    callback,
    _return_both,
    **kwargs,
):
    """Whole-grid propagation (see :mod:`quantumpropagators_torch.fused`)."""
    import torch

    from .fused import cheby_propagate_fused
    from .ops.operators import as_tensor, host_np, is_operator, op_dot

    if str(method).lower() not in ("cheby", "auto", "newton_leja"):
        raise ValueError(
            "fused=True supports method='cheby' or 'newton_leja'"
        )
    if callback is not None:
        raise ValueError(
            "fused=True runs entirely on device; per-step host callbacks "
            "are unsupported (use observables instead)"
        )
    state = as_tensor(state)
    tlist = np.asarray(tlist, dtype=np.float64)
    max_bytes = int(kwargs.pop("max_storage_bytes", 8 << 30))
    observable_fn = None
    store_states = False
    if storage is not None and storage is not False:
        if observables is None:
            store_states = True
            # memory-cliff guard: storing every state materializes an
            # (nt-1, N) trajectory on host.  At the BASELINE 2^24 x 1000
            # steps config that is terabytes -- refuse and point at the
            # streaming alternative instead of OOM-killing the host.
            n_state = int(state.numel())
            est_bytes = (len(tlist) - 1) * n_state * state.element_size()
            if est_bytes > max_bytes:
                raise ValueError(
                    f"fused=True with storage of all states would "
                    f"materialize ~{est_bytes / 2**30:.1f} GiB on host "
                    f"(> {max_bytes / 2**30:.1f} GiB limit). Pass "
                    f"`observables=...` to stream expectation values "
                    f"instead, raise `max_storage_bytes`, or use the "
                    f"stepwise path (fused=False) with a callback."
                )
        else:
            obs = observables if isinstance(observables, (tuple, list)) else (observables,)

            def observable_fn(psi, _obs=tuple(obs)):
                vals = []
                for o in _obs:
                    if is_operator(o):
                        vals.append(op_dot(psi, o, psi))
                    else:
                        vals.append(torch.as_tensor(o(psi)))
                return vals[0] if len(vals) == 1 else torch.stack(vals)

    if str(method).lower() == "newton_leja":
        # fixed-Leja Newton in complex128 (Hermitian generators): see
        # ops/newton_leja.py
        from .ops.newton_leja import newton_leja_propagate_dd

        psi_final, outputs, _plan = newton_leja_propagate_dd(
            state,
            generator,
            tlist,
            observable_fn=observable_fn,
            store_states=store_states,
            backward=backward,
            **kwargs,
        )
        psi_final = psi_final.reshape(state.shape)
    else:
        psi_final, outputs = cheby_propagate_fused(
            state,
            generator,
            tlist,
            observable_fn=observable_fn,
            store_states=store_states,
            backward=backward,
            **kwargs,
        )
    out_storage = None
    if storage is not None and storage is not False:
        if store_states:
            first = host_np(state).reshape(-1)
        else:
            first = host_np(observable_fn(state))
        series = host_np(outputs)  # (nt-1, ...) in propagation order
        if backward:
            series = series[::-1]
            full = np.concatenate([series, first[None, ...]], axis=0)
        else:
            full = np.concatenate([first[None, ...], series], axis=0)
        out_storage = np.moveaxis(full, 0, -1)  # time axis last
        if storage is not True:
            storage[...] = out_storage
            out_storage = storage
    if _return_both:
        return psi_final, out_storage
    if storage is True:
        return out_storage
    return psi_final


def propagate_propagator(
    propagator: Propagator,
    *,
    storage=None,
    observables=None,
    callback: Optional[Callable] = None,
    show_progress: bool = False,
    _return_both: bool = False,
):
    """Run the outer time loop of an initialized propagator (reference
    ``src/propagate.jl:283-342``)."""
    tlist = np.asarray(propagator.tlist)
    nt = len(tlist)
    backward = propagator.backward
    return_storage = False
    if observables is None:
        observables = (_StoreState(),)
    start_idx = nt - 1 if backward else 0
    if storage is True:
        data0 = map_observables(observables, propagator.state, tlist, start_idx)
        storage = init_storage(data0, nt)
        return_storage = True
    if storage is not None and storage is not False:
        data0 = map_observables(observables, propagator.state, tlist, start_idx)
        write_to_storage(storage, start_idx, data0)

    intervals = range(nt - 2, -1, -1) if backward else range(nt - 1)
    progress = None
    if show_progress:
        try:  # pragma: no cover - cosmetic
            from tqdm import tqdm

            progress = tqdm(total=nt - 1, desc="propagate")
        except Exception:
            progress = None
    for i in intervals:
        psi = propagator.prop_step()
        if psi is None:
            break
        if callback is not None:
            callback(propagator, observables)
        if storage is not None and storage is not False:
            grid_idx = i if backward else i + 1
            data = map_observables(observables, propagator.state, tlist, grid_idx)
            write_to_storage(storage, grid_idx, data)
        if progress is not None:
            progress.update(1)
    if progress is not None:
        progress.close()
    if _return_both:
        return propagator.state, (storage if storage is not False else None)
    if return_storage:
        return storage
    return propagator.state


@dataclass
class Propagation:
    """Arguments bundle for one stage of :func:`propagate_sequence`
    (reference ``src/propagate_sequence.jl:25-31``)."""

    generator: Any
    tlist: Any
    kwargs: dict = field(default_factory=dict)

    def __init__(self, generator, tlist, **kwargs):
        self.generator = generator
        self.tlist = tlist
        self.kwargs = kwargs


def propagate_sequence(
    state,
    propagations: Sequence[Propagation],
    *,
    storage=None,
    pre_propagation: Optional[Callable] = None,
    post_propagation: Optional[Callable] = None,
    **kwargs,
):
    """Chain multiple :func:`propagate` calls, each one's output feeding
    the next (reference ``src/propagate_sequence.jl:90-131``).

    Per-stage ``pre_propagation(state)`` / ``post_propagation(state)``
    hooks (e.g. frame changes) may be given globally or per stage in the
    :class:`Propagation` kwargs.  With ``storage=True``, returns the
    list of per-stage storage objects; otherwise the final state.
    """
    storages = []
    psi = state
    for prop in propagations:
        stage_kwargs = dict(kwargs)
        stage_kwargs.update(prop.kwargs)
        pre = stage_kwargs.pop("pre_propagation", pre_propagation)
        post = stage_kwargs.pop("post_propagation", post_propagation)
        stage_storage = stage_kwargs.pop("storage", storage)
        if pre is not None:
            psi = pre(psi)
        psi, stage_data = propagate(
            psi,
            prop.generator,
            prop.tlist,
            storage=stage_storage,
            _return_both=True,
            **stage_kwargs,
        )
        if stage_storage is True:
            storages.append(stage_data)
        if post is not None:
            psi = post(psi)
    if storage is True:
        return storages
    return psi
