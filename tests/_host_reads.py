"""A ``TorchDispatchMode`` that flags what a CUDA graph cannot hold, shared
by the decode-program and train-program tests: run a step on ``meta``
tensors (a device that is not the host) under ``HostReads`` and read
``found``."""
import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_HOST_READS = {aten._local_scalar_dense, aten.nonzero, aten.bincount,
               aten.masked_select, aten.equal, aten._unique, aten._unique2,
               aten.unique_dim, aten.unique_consecutive}
_INDEXING = {aten.index, aten.index_put, aten.index_put_,
             aten._index_put_impl_}


class HostReads(TorchDispatchMode):
    """Notes every operation that would read a device value on the host,
    or copy host data to the device, in a step whose tensors lie on a
    device (``meta`` here, the card there): a CUDA graph can hold
    neither."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        pkt = func.overloadpacket
        if pkt in _HOST_READS:
            self.found.append(str(func))
        elif func is aten.repeat_interleave.Tensor and \
                kwargs.get("output_size") is None:
            self.found.append(f"{func} without output_size")
        elif pkt in _INDEXING and any(
                t is not None and t.dtype in (torch.bool, torch.uint8)
                for t in args[1]):
            self.found.append(f"{func} with a boolean index")
        elif pkt is aten.copy_ and args[0].device.type != "cpu" and \
                args[1].device.type == "cpu":
            self.found.append(f"{func} from the host")
        elif pkt is aten._to_copy and args[0].device.type == "cpu" and \
                torch.device(kwargs.get("device") or "cpu").type != "cpu":
            self.found.append(f"{func} from the host")
        return func(*args, **kwargs)


def on_meta(tree):
    if isinstance(tree, dict):
        return {k: on_meta(v) for k, v in tree.items()}
    return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype,
                               device="meta")
