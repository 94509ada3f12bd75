from .telemetry import Telemetry, span

__all__ = ["Telemetry", "span"]
