"""Faults planted in the timed path once a run's set-up is done, each a
``fault(deploy)`` that ``run_cell`` calls: the fault tests plant them at a
tiny size on the CPU, ``tools/control.py --fault`` at a cell's own size on
the card. The decode faults replace a function of the port's modules for
the rest of the process."""
import torch


def _each_forward(deploy, wrap):
    for tm in deploy.engines.values():
        tm.forward = wrap(tm.forward)


def alter_answer(deploy):
    """An answer altered where it is produced: each output's first row has
    its largest and smallest entries swapped."""
    def wrap(f):
        def forward(p, x):
            out = f(p, x).clone()
            row = out.reshape(out.shape[0], -1)[0]
            hi, lo = row.argmax(), row.argmin()
            row[hi], row[lo] = row[lo].clone(), row[hi].clone()
            return out
        return forward
    _each_forward(deploy, wrap)


def half_batch(deploy):
    """Half of the batch left out, the rest filled with the mean of the
    rows computed."""
    def wrap(f):
        def forward(p, x):
            rows = x[0] if isinstance(x, tuple) else x
            half = rows.shape[0] // 2
            if half == 0:
                return f(p, x)
            part = f(p, (rows[:half],) + x[1:] if isinstance(x, tuple)
                     else rows[:half])
            rest = part.mean(dim=0, keepdim=True).expand(
                rows.shape[0] - half, *part.shape[1:])
            return torch.cat([part, rest.to(part.dtype)])
        return forward
    _each_forward(deploy, wrap)


_PORT = {}      # (module, name) -> the function as the port has it


def _replace(module, name, make):
    """module.name = make(the port's function); planted again in one
    process, a fault replaces the port's function, not a faulted one."""
    current = getattr(module, name)
    if not getattr(current, "planted", False):
        _PORT[(module.__name__, name)] = current
    faulted = make(_PORT[(module.__name__, name)])
    faulted.planted = True
    setattr(module, name, faulted)


def unchanged_state(deploy):
    """A decode step that leaves its state unchanged: the new token's key
    and value never written to the cache."""
    from repro_torch.models import attention
    _replace(attention, "_write_slot",
             lambda write: lambda buf, slot, row: None)


def _mask(slots):
    def fault(deploy):
        from repro_torch.kernels import ops

        def make(decode):
            def flash_decode(q, k, v, kpos, cur, **kw):
                return decode(q, *slots(k, v, kpos, cur), **kw)
            return flash_decode
        _replace(ops, "flash_decode", make)
    return fault


# the live-slot mask ignored: every slot of the cache attended
every_slot = _mask(lambda k, v, kpos, cur: (k, v, kpos, k.shape[1] - 1))
# the cache skipped: only the new token's own slot attended
own_slot = _mask(lambda k, v, kpos, cur: (
    k[:, cur:cur + 1], v[:, cur:cur + 1], kpos[cur:cur + 1], cur))

FAULTS = {"alter_answer": alter_answer, "half_batch": half_batch,
          "unchanged_state": unchanged_state, "every_slot": every_slot,
          "own_slot": own_slot}
