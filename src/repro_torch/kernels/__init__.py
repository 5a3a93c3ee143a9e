"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
twins: ``changepoint`` (the paper's SSE scan, batched, argmin fused) and
``windowvet`` (the whole vet pipeline per ragged window, one launch).

``runtime`` holds the device policy and builds/loads the kernel library.
A wrapper given CPU tensors runs the plain version (the port's analogue of
Pallas interpret mode); given CUDA tensors it launches its kernel or
raises."""
