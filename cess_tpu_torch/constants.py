"""Protocol constants of cess-tpu.

The port's own copy of ``cess_tpu/constants.py`` (the port imports
nothing from that package), with its whole surface: the data-plane and
audit geometry the kernels read, and the chain constants the pallets of
``cess_tpu_torch/chain`` read. Values must stay identical: tags,
challenges, proofs, deals and rewards are protocol facts shared by both
packages. The citations point into the reference chain's sources.
"""

MIB = 1024 * 1024

# --- data-plane geometry (primitives/common/src/lib.rs:56-62) ---
SEGMENT_SIZE = 16 * MIB          # bytes per segment
FRAGMENT_SIZE = 8 * MIB          # bytes per fragment in the reference (k=2) geometry
CHUNK_COUNT = 1024               # audit chunks per fragment

# Reference snapshot erasure geometry: 3 fragments per segment = RS(k=2, m=1)
# (runtime/src/lib.rs:1026-1027, redundancy math c-pallets/file-bank/src/lib.rs:440)
REF_K = 2
REF_M = 1
FRAGMENT_COUNT = REF_K + REF_M

# BASELINE.json target geometry: RS(4+8) = 12 fragments/segment
BASE_K = 4
BASE_M = 8

# --- audit (c-pallets/audit/src/lib.rs) ---
CHALLENGE_RATE_NUM = 46          # 46/1000 of CHUNK_COUNT chunks challenged per round
CHALLENGE_RATE_DEN = 1000        # c-pallets/audit/src/lib.rs:956
CHALLENGE_RANDOM_LEN = 20        # 20-byte randoms per challenged chunk (:966-974)
CHALLENGE_MINER_MAX = 8000       # runtime/src/lib.rs:988
VERIFY_MISSION_MAX = 500         # runtime/src/lib.rs:990
SIGMA_MAX = 2048                 # proof blob cap, runtime/src/lib.rs:992
AUDIT_FAULT_TOLERANCE = 2        # consecutive failures before punish, audit/src/constants.rs:1-3

# --- chain timing (runtime/src/lib.rs:234-255,561) ---
MILLISECS_PER_BLOCK = 6000
BLOCKS_PER_HOUR = 600
EPOCH_DURATION_BLOCKS = BLOCKS_PER_HOUR          # 1 h epochs
SESSIONS_PER_ERA = 6

# --- file-bank (runtime/src/lib.rs:1026-1032, c-pallets/file-bank) ---
SEGMENT_COUNT_MAX = 1000         # max segments per deal, runtime/src/lib.rs:1014,1032
DEAL_TIMEOUT_BLOCKS = 600        # per assigned miner, file-bank/src/functions.rs:156
DEAL_MAX_RETRIES = 5             # file-bank/src/lib.rs:511
SPACE_OVERHEAD_NUM = 3           # needed space = segs * SEGMENT_SIZE * 1.5
SPACE_OVERHEAD_DEN = 2           # file-bank/src/lib.rs:440-441
RESTORAL_ORDER_LIFE = 250        # blocks, restoral order deadline
FROZEN_SWEEP_MAX_FILES = 300     # lease-GC files per block, file-bank/src/lib.rs:362-402

# --- sminer economics (c-pallets/sminer/src/constants.rs, lib.rs) ---
IDLE_POWER_WEIGHT_NUM = 3        # power = 30% idle + 70% service (lib.rs:665-673)
SERVICE_POWER_WEIGHT_NUM = 7
POWER_WEIGHT_DEN = 10
REWARD_IMMEDIATE_NUM = 2         # 20% of reward order released immediately
REWARD_IMMEDIATE_DEN = 10        # sminer/src/lib.rs:675-733
RELEASE_NUMBER = 180             # tranches for the remaining 80% (prod value; test=2)
BASE_COLLATERAL = 2000           # CESS per (1 + power/TiB), sminer constants.rs:27
TIB = 1024 * 1024 * MIB

# punish tiers for missed challenges: 30% / 60% / 100% of collateral limit
CLEAR_PUNISH_TIERS = (30, 60, 100)   # c-pallets/audit/src/lib.rs:614-655

# --- staking economics (c-pallets/staking, runtime/src/lib.rs:585-589) ---
DOLLARS = 10 ** 12               # token base unit (12 decimals, typical CESS config)
VALIDATOR_REWARD_YEAR1 = 238_500_000 * DOLLARS
SMINER_REWARD_YEAR1 = 477_000_000 * DOLLARS
REWARD_DECAY_NUM = 841           # x0.841 per year for 30 years
REWARD_DECAY_DEN = 1000
REWARD_YEARS = 30
SCHEDULER_SLASH_PERMILL = 50     # slash_scheduler = 5% of MinValidatorBond
MIN_ELECTABLE_STAKE = 3_000_000 * DOLLARS   # runtime/src/lib.rs:764-772

# --- storage-handler ---
GIB = 1024 * MIB
SPACE_UNIT_GIB = 1               # price unit: per GiB per 30 days
ONE_DAY_BLOCKS = 14400           # 6 s blocks
MONTH_BLOCKS = 30 * ONE_DAY_BLOCKS

# --- scheduler-credit (c-pallets/scheduler-credit/src/lib.rs:36-42,61-75) ---
CREDIT_HISTORY_WEIGHTS = (50, 20, 15, 10, 5)   # percent, most-recent first
CREDIT_SCORE_SCALE = 1000

# --- transaction fees (TransactionPayment; runtime/src/lib.rs:190-204) ---
# 80% of fees to treasury, 20% to block author; values are framework
# choices (the reference derives them from weight benchmarks)
TX_BASE_FEE = 10 ** 8            # 1e-4 DOLLARS flat per signed extrinsic
TX_BYTE_FEE = 10 ** 5            # per encoded byte

# --- consensus (RRSC; runtime/src/lib.rs:181-185,240-241) ---
RRSC_C_NUM = 1                   # VRF threshold c = 1/4
RRSC_C_DEN = 4
