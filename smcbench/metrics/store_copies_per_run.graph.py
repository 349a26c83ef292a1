"""store_copies_per_run.graph: packed trace stores copied whole per
filter run by the store's writer (``core/packed.py`` ``STORE_WRITES``:
``write_steps`` into a copy of the whole ``[T*R, N]`` store, where it
does not write the store in place), counted once at the capture outside
the IF bodies (``CapturedRun.store_writes``), so those of every replay.
Nothing in an eager cell, or where the program has no such counter."""


def read(rec):
    writes = getattr(rec.program.captured, "store_writes", None)
    if writes is None:
        return None
    return writes["copied"]
