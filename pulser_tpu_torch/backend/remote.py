"""The remote-execution layer: connections, backends and lazy results.

Behavioral parity with reference
``pulser-core/pulser/backend/remote.py:32-442``: the
``RemoteConnection`` protocol, ``RemoteResults`` (deferred fetching by
batch/job id), ``RemoteBackend`` with job-parameter validation and the
open-batch context manager.
"""

from __future__ import annotations

import logging
import typing
from abc import ABC, abstractmethod
from enum import Enum, auto
from types import TracebackType
from typing import Any, Mapping, Type, TypedDict

from pulser_tpu_torch.backend.abc import Backend
from pulser_tpu_torch.backend.config import BackendConfig
from pulser_tpu_torch.backend.results import Results, ResultsSequence
from pulser_tpu_torch.devices._device_datacls import Device
from pulser_tpu_torch.sequence import Sequence


class JobParams(TypedDict, total=False):
    """Execution parameters of one job within a batch."""

    runs: int
    variables: dict[str, Any]


class BatchStatus(Enum):
    """The lifecycle states of a submitted batch."""

    PENDING = auto()
    RUNNING = auto()
    DONE = auto()
    CANCELED = auto()
    TIMED_OUT = auto()
    ERROR = auto()
    PAUSED = auto()


class JobStatus(Enum):
    """The lifecycle states of one job within a batch."""

    PENDING = auto()
    RUNNING = auto()
    DONE = auto()
    CANCELED = auto()
    ERROR = auto()
    PAUSED = auto()


class RemoteResultsError(Exception):
    """Raised when remote results cannot be retrieved."""


class RemoteConnection(ABC):
    """The protocol a remote execution service must implement."""

    @abstractmethod
    def submit(
        self,
        sequence: Sequence,
        wait: bool = False,
        open: bool = False,
        batch_id: str | None = None,
        **kwargs: Any,
    ) -> RemoteResults:
        """Submits a sequence for execution."""
        pass

    @abstractmethod
    def _fetch_result(
        self, batch_id: str, job_ids: list[str] | None
    ) -> typing.Sequence[Results]:
        """Retrieves the results of a finished batch."""
        pass

    @abstractmethod
    def _query_job_progress(
        self, batch_id: str
    ) -> Mapping[str, tuple[JobStatus, Results | None]]:
        """Per-job status and (possibly partial) results of a batch.

        Never raises for jobs that have not finished — their results
        entry is simply None.
        """
        pass

    @abstractmethod
    def _get_batch_status(self, batch_id: str) -> BatchStatus:
        """The current status of a batch."""
        pass

    @abstractmethod
    def supports_open_batch(self) -> bool:
        """Whether this connection can create open batches."""
        pass

    def _get_job_ids(self, batch_id: str) -> list[str]:
        """The ids of every job in a batch (optional capability)."""
        raise NotImplementedError(
            "Unable to find job IDs through this remote connection."
        )

    def fetch_available_devices(self) -> dict[str, Device]:
        """The devices reachable via this connection (optional)."""
        raise NotImplementedError(
            "Unable to fetch the available devices through this "
            "remote connection."
        )

    def _close_batch(self, batch_id: str) -> None:
        """Closes an open batch (optional capability)."""
        raise NotImplementedError(  # pragma: no cover
            "Unable to close batch through this remote connection"
        )

    @staticmethod
    def _add_measurement_to_sequence(sequence: Sequence) -> Sequence:
        """Appends an implicit measurement when exactly one basis is used.

        The sequence is deep-copied through a serialization roundtrip,
        which also converts any tensors to plain arrays.
        """
        if sequence.is_measured():
            return sequence
        bases = sequence.get_addressed_bases()
        if len(bases) != 1:
            raise ValueError(
                "The measurement basis can't be implicitly determined "
                "for a sequence not addressing a single basis."
            )
        sequence = Sequence.from_abstract_repr(
            sequence.to_abstract_repr(skip_validation=True)
        )
        sequence.measure(bases[0])
        return sequence

    def update_sequence_device(self, sequence: Sequence) -> Sequence:
        """Swaps the sequence's device for its current remote version.

        Args:
            sequence: The sequence whose device to refresh.

        Returns:
            The sequence, rebuilt on the up-to-date device when the
            stored one is stale.
        """
        try:
            available_devices = self.fetch_available_devices()
        except NotImplementedError:
            logging.warning(
                "The selected connection doesn't give access to the"
                " latest device specs. Execution might fail if the"
                " sequence is incompatible with the device."
            )
            return sequence

        by_name = {
            dev.name: key for key, dev in available_devices.items()
        }
        err_suffix = (
            " Please fetch the latest devices with "
            f"`{type(self).__name__}.fetch_available_devices()` and"
            " rebuild the sequence with one of the options."
        )
        name = sequence.device.name
        if name not in by_name:
            raise ValueError(
                "The device used in the sequence does not match any "
                "of the devices currently available through the"
                " remote connection." + err_suffix
            )
        new_device = available_devices[by_name[name]]
        if sequence.device == new_device:
            return sequence
        try:
            sequence = sequence.with_new_device(new_device, strict=True)
        except Exception as e:
            raise ValueError(
                "The sequence is not compatible with the latest "
                "device specs." + err_suffix
            ) from e
        # The refreshed sequence must also clear the QPU checks
        RemoteBackend.validate_sequence(sequence, mimic_qpu=True)
        return sequence


class RemoteResults(ResultsSequence):
    """Results that materialize lazily over a remote connection.

    Args:
        batch_id: The batch whose results these are.
        connection: The connection used for status/result queries.
        job_ids: An optional subset (and ordering) of the batch's jobs
            to include; all jobs by default.
    """

    def __init__(
        self,
        batch_id: str,
        connection: RemoteConnection,
        job_ids: list[str] | None = None,
    ):
        """Binds the results to a batch on a connection."""
        self._batch_id = batch_id
        self._connection = connection
        if job_ids is not None:
            known = self._connection._get_job_ids(self._batch_id)
            unknown = [id_ for id_ in job_ids if id_ not in known]
            if unknown:
                raise RuntimeError(
                    f"Batch {self._batch_id!r} does not contain jobs "
                    f"{unknown}."
                )
        self._job_ids = job_ids

    @property
    def results(self) -> tuple[Results, ...]:
        """The results; triggers the fetch on first access."""
        return self._results_seq

    @property
    def batch_id(self) -> str:
        """The id of the underlying batch."""
        return self._batch_id

    @property
    def job_ids(self) -> list[str]:
        """The ids of the jobs included in these results."""
        if self._job_ids is None:
            return self._connection._get_job_ids(self._batch_id)
        return self._job_ids

    def get_batch_status(self) -> BatchStatus:
        """The batch's current status."""
        return self._connection._get_batch_status(self._batch_id)

    def get_available_results(self) -> dict[str, Results]:
        """Results of the jobs that have finished so far.

        Returns:
            Job id -> results, omitting unfinished jobs (no error is
            raised, unlike the `results` property).
        """
        progress = self._connection._query_job_progress(self.batch_id)
        done = {
            job: res for job, (_, res) in progress.items()
            if res is not None
        }
        if self._job_ids:
            return {
                k: v for k, v in done.items() if k in self._job_ids
            }
        return done

    def __getattr__(self, name: str) -> Any:
        if name == "_results_seq":
            try:
                self._results_seq = tuple(
                    self._connection._fetch_result(
                        self.batch_id, self._job_ids
                    )
                )
            except RemoteResultsError as e:
                raise RemoteResultsError(
                    "Results are not available for all jobs. Use the "
                    "`get_available_results` method to retrieve"
                    " partial results."
                ) from e
            return self._results_seq
        raise AttributeError(
            f"'RemoteResults' object has no attribute '{name}'."
        )


class RemoteBackend(Backend):
    """A backend that executes sequences over a remote connection.

    Args:
        sequence: The sequence to execute remotely.
        connection: The connection carrying the submissions.
        mimic_qpu: Apply the validations a physical QPU would.
        config: Optional backend configuration.
    """

    _config: BackendConfig

    def __init__(
        self,
        sequence: Sequence,
        connection: RemoteConnection,
        mimic_qpu: bool = False,
        *,
        config: BackendConfig | None = None,
    ) -> None:
        """Validates the sequence, connection and configuration."""
        super().__init__(sequence, mimic_qpu=mimic_qpu)
        if not isinstance(connection, RemoteConnection):
            raise TypeError(
                "'connection' must be a valid RemoteConnection"
                " instance."
            )
        self._connection = connection
        if config is None:
            config = BackendConfig()
        elif not isinstance(config, BackendConfig):
            raise TypeError(
                "When given, a 'config' must be an instance of "
                f"'BackendConfig'; got {type(config).__name__!r}"
                " instead."
            )
        self._config = config
        self._batch_id: str | None = None

    def run(
        self,
        job_params: list[JobParams] | None = None,
        wait: bool = False,
    ) -> RemoteResults:
        """Submits the sequence and returns its (lazy) results.

        Args:
            job_params: Per-job execution parameters; a parametrized
                sequence needs each job's variable values under
                'variables'.
            wait: Block until all jobs have results (otherwise the
                returned object's status can be polled).
        """
        if self._mimic_qpu:
            sequence = self._connection.update_sequence_device(
                self._sequence
            )
            self.validate_job_params(
                job_params, sequence.device.max_runs
            )
        elif job_params is not None:
            self._type_check_job_params(job_params)

        return self._connection.submit(
            self._sequence,
            job_params=job_params,
            wait=wait,
            **self._submit_kwargs(),
        )

    def open_batch(self) -> _OpenBatchContextManager:
        """Opens a batch; submissions inside the context share it."""
        if not self._connection.supports_open_batch():
            raise NotImplementedError(
                "Unable to execute open_batch using this remote"
                " connection"
            )
        return _OpenBatchContextManager(self)

    def _submit_kwargs(self) -> dict[str, Any]:
        """Extra keyword arguments attached to every submit() call."""
        return dict(batch_id=self._batch_id)

    @staticmethod
    def _type_check_job_params(
        job_params: list[JobParams] | None,
    ) -> None:
        if not isinstance(job_params, list):
            raise TypeError(
                "'job_params' must be a list; "
                f"got {type(job_params)} instead."
            )
        for d in job_params:
            if not isinstance(d, dict):
                raise TypeError(
                    "All elements of 'job_params' must be"
                    f" dictionaries; got {type(d)} instead."
                )

    @staticmethod
    def validate_job_params(
        job_params: list[JobParams] | None, max_runs: int | None
    ) -> None:
        """QPU-grade validation of the job parameters."""
        suffix = " when executing a sequence on a real QPU."
        if not job_params:
            raise ValueError("'job_params' must be specified" + suffix)
        RemoteBackend._type_check_job_params(job_params)
        for j in job_params:
            if "runs" not in j:
                raise ValueError(
                    "All elements of 'job_params' must specify 'runs'"
                    + suffix
                )
            if max_runs is not None and j["runs"] > max_runs:
                raise ValueError(
                    "All 'runs' must be below the maximum allowed by"
                    f" the device ({max_runs})" + suffix
                )


class _OpenBatchContextManager:
    """Binds a RemoteBackend to an open batch for its lifetime."""

    def __init__(self, backend: RemoteBackend) -> None:
        self.backend = backend

    def __enter__(self) -> _OpenBatchContextManager:
        batch = self.backend._connection.submit(
            self.backend._sequence,
            open=True,
            **self.backend._submit_kwargs(),
        )
        self.backend._batch_id = batch.batch_id
        return self

    def __exit__(
        self,
        exc_type: Type[BaseException] | None,
        exc_value: BaseException | None,
        traceback: TracebackType | None,
    ) -> None:
        if self.backend._batch_id:
            self.backend._connection._close_batch(
                self.backend._batch_id
            )
        self.backend._batch_id = None
