from .ops import mlstm_chunk

__all__ = ["mlstm_chunk"]
