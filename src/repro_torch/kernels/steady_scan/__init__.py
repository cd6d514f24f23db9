from repro_torch.kernels.steady_scan.ops import steady_scan, steady_scan_plain

__all__ = ["steady_scan", "steady_scan_plain"]
