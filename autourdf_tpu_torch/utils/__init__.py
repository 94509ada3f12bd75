from .telemetry import Telemetry, torch_trace

__all__ = ["Telemetry", "torch_trace"]
