from .jsonc import read_jsonc_file
from .subst import SubstData, parse_subst_file
from .fasta import Seq, SeqData, read_fasta, parse_seq_file, FormatError
from .pairs import read_seq_pairs, parse_seq_pair_file, default_pairs
from .tsv import TsvPrintCtl, write_result_to_tsv
from .params import parse_alg_params_file

__all__ = [
    "read_jsonc_file",
    "SubstData",
    "parse_subst_file",
    "Seq",
    "SeqData",
    "read_fasta",
    "parse_seq_file",
    "FormatError",
    "read_seq_pairs",
    "parse_seq_pair_file",
    "default_pairs",
    "TsvPrintCtl",
    "write_result_to_tsv",
    "parse_alg_params_file",
]
