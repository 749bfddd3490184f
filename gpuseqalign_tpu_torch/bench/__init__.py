from .driver import benchmark_algs, BenchmarkData
from .cli import main, parse_cmd_args, CmdArgs

__all__ = ["benchmark_algs", "BenchmarkData", "main", "parse_cmd_args", "CmdArgs"]
