"""Synchronous ThreadPoolExecutor drop-in (the port's copy of
surya_tpu/detection/parallel.py; reference: surya/detection/parallel.py)."""


class FakeFuture:
    def __init__(self, fn, *args, **kwargs):
        self._result = fn(*args, **kwargs)

    def result(self):
        return self._result


class FakeExecutor:
    def __init__(self, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args, **kwargs):
        return FakeFuture(fn, *args, **kwargs)
