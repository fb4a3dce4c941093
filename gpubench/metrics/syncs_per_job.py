"""Host calls a job makes that wait for the card, from the trace:
``cudaStreamSynchronize`` (one per PyTorch ``.item()`` or ``.cpu()``),
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, and blocking
device-to-host ``cudaMemcpy``."""


def read(w):
    if w.trace is None or not w.traced_jobs:
        return None
    return w.trace.syncs() / w.traced_jobs
