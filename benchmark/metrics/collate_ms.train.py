"""``collate_ms.train``: Host ms a batch of the loader's next() (loader.DataLoader, loader.collate), the mean over the window's batches."""
from benchmark.readers import loader_ms as read  # noqa: F401
