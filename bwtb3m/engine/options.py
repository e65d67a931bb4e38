"""Construction options — equivalent of ``BwtMergeSortOptions``.

The reference's option surface (/root/reference/src/bwtb3m.cpp:43-56 and
README options block): inputtype, outputfilename, sasamplingrate=32,
isasamplingrate=262144, mem=2G, numthreads=8, bwtonly=0/1, tmpprefix,
sparsetmpprefix, copyinputtomemory, largelcpthres=16384, verbose.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..util.args import ArgInfo


@dataclasses.dataclass
class BwtOptions:
    input_path: str
    input_type: str = "bytestream"
    output_filename: Optional[str] = None
    sa_sampling_rate: int = 32            # bwtb3m.cpp:45 default
    isa_sampling_rate: int = 262144       # bwtb3m.cpp:46 default
    mem: int = 2 * 1024 ** 3              # bwtb3m.cpp:47 default 2GiB
    num_threads: int = 8                  # bwtb3m.cpp:49 default (host advisory)
    bwt_only: bool = False                # bwtb3m.cpp bwtonly=0/1
    tmp_prefix: Optional[str] = None
    sparse_tmp_prefix: Optional[str] = None
    copy_input_to_memory: bool = False
    large_lcp_thres: int = 16384          # bwtb3m.cpp:55 default
    verbose: int = 1
    bwt_codec: str = "rl"            # rl (byte-aligned RLB1) | rlh (Huffman+gamma RLH1)
    engine: str = "auto"             # auto | doubling | merge
    # device-engine knobs (no reference analog):
    # per-device doubling block budget; derived from mem when unset —
    # the reference's mem= bounds the per-block in-RAM sort the same way
    # (bwtb3m.cpp:47); the doubling sorter holds ~16 bytes/symbol of
    # device state.
    max_block_symbols: Optional[int] = None
    preisa_sampling_rate: Optional[int] = None  # defaults to isa_sampling_rate
    # run all pair merges of one tree level in shared device dispatches
    # (ops/gapbatch.py) when their combined state fits HBM; batchmerges=0
    # forces the per-pair path
    batch_merges: bool = True
    # durable merge-tree checkpointing (reference: serializable block
    # jobs + tmpprefix durability, bwtb3m.cpp:52-53 / checkbwt.cpp:24):
    # persist completed regions >= checkpoint_min_symbols under
    # tmp_prefix and resume from the deepest complete tree nodes
    checkpoint: bool = True
    checkpoint_min_symbols: int = 1 << 26
    # bounded host memory (reference: the mem=2G semi-external
    # discipline, bwtb3m.cpp:47): when set and the text would not
    # comfortably fit, the engine reads it through a read-only memmap
    # under tmp_prefix instead of RAM
    host_mem: Optional[int] = None
    # walk-lane budget of the scaled engine's chain/anchor kernels
    # (numthreads analog for the device): default 2^16; small CPU-mesh
    # runs want this low — padded lanes cost compute even when masked
    lane_bucket: Optional[int] = None

    def __post_init__(self):
        if self.max_block_symbols is None:
            self.max_block_symbols = min(1 << 27, max(1 << 10, self.mem // 16))
        # preisa density drives the lane count of every later batched LF
        # walk (checkbwt / bwtcomputessa): walk throughput grows with batch
        # width, so when unset the engine picks a rate targeting ~128k
        # lanes at construction time (None = adaptive).
        if self.output_filename is None:
            self.output_filename = self.input_path + ".bwt"
        if self.tmp_prefix is None:
            self.tmp_prefix = self.output_filename + "_tmp"
        if self.sparse_tmp_prefix is None:
            self.sparse_tmp_prefix = self.tmp_prefix + "_sparse"


    @property
    def base_name(self) -> str:
        """Output base: 'x.bwt' -> 'x' so sidecars are x.hist, x.preisa..."""
        out = self.output_filename
        return out[:-4] if out.endswith(".bwt") else out

    @classmethod
    def from_arginfo(cls, ai: ArgInfo) -> "BwtOptions":
        if not ai.restargs:
            raise ValueError("no input file given")
        return cls(
            input_path=ai.restargs[0],
            input_type=ai.get("inputtype", "bytestream"),
            output_filename=ai.get("outputfilename") or None,
            sa_sampling_rate=ai.get_int("sasamplingrate", 32),
            isa_sampling_rate=ai.get_int("isasamplingrate", 262144),
            mem=ai.get_int("mem", 2 * 1024 ** 3),
            num_threads=ai.get_int("numthreads", 8),
            bwt_only=ai.get_bool("bwtonly", False),
            tmp_prefix=ai.get("tmpprefix") or None,
            sparse_tmp_prefix=ai.get("sparsetmpprefix") or None,
            copy_input_to_memory=ai.get_bool("copyinputtomemory", False),
            large_lcp_thres=ai.get_int("largelcpthres", 16384),
            verbose=ai.get_int("verbose", 1),
            bwt_codec=ai.get("bwtcodec", "rl"),
            engine=ai.get("engine", "auto"),
            preisa_sampling_rate=(
                ai.get_int("preisasamplingrate", 0) or None),
            batch_merges=ai.get_bool("batchmerges", True),
            checkpoint=ai.get_bool("checkpoint", True),
            checkpoint_min_symbols=ai.get_int("checkpointminsize",
                                              1 << 26),
            host_mem=ai.get_int("hostmem", 0) or None,
            lane_bucket=ai.get_int("lanes", 0) or None,
        )
