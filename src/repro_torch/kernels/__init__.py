"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
twins: ``changepoint`` (the paper's estimator from sorted values to t,
ragged rows, one launch),
``windowvet`` (the whole vet pipeline per ragged window, one launch),
``ssd`` (the Mamba2 chunked scan, one block per batch row and head) and
``flash_attention`` (causal / sliding-window GQA attention, one block per
batch row, head and 64-query tile).

``runtime`` holds the device policy and builds/loads the kernel library.
A wrapper given CPU tensors runs the plain version (the port's analogue of
Pallas interpret mode); given CUDA tensors it launches its kernel or
raises."""
