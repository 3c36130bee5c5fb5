"""Host-side C++ (counterpart of :mod:`pyhgt_tpu.native`): the HGSampling
sampler and the batch-prep core of the sorted-edge layout, bound with
ctypes and built on first use (:mod:`pyhgt_tpu_torch.native.build`)."""
