"""History work units (reference `src/historywork`).

Copied from `stellar_core_tpu/historywork/__init__.py` at commit 89bbd6f;
carry a fix in either copy to the other."""

from .apply_works import (ApplyBucketsWork, ApplyCheckpointWork,
                          DownloadApplyTxsWork, checkpoint_verify_triples)
from .works import (BatchDownloadWork, DownloadBucketsWork,
                    GetAndUnzipRemoteFileWork, GetHistoryArchiveStateWork,
                    GetRemoteFileWork, GunzipFileWork, GzipFileWork,
                    MakeRemoteDirWork, PutRemoteFileWork, RunCommandWork,
                    VerifyBucketWork, VerifyLedgerChainWork)

__all__ = [
    "ApplyBucketsWork", "ApplyCheckpointWork", "BatchDownloadWork",
    "DownloadApplyTxsWork", "DownloadBucketsWork",
    "GetAndUnzipRemoteFileWork", "GetHistoryArchiveStateWork",
    "GetRemoteFileWork", "GunzipFileWork", "GzipFileWork",
    "MakeRemoteDirWork", "PutRemoteFileWork", "RunCommandWork",
    "VerifyBucketWork", "VerifyLedgerChainWork",
    "checkpoint_verify_triples",
]
