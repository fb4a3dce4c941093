"""The backend class for QPU execution.

Behavioral parity with reference
``pulser-core/pulser/backend/qpu.py:27-87`` (``QPUBackend``).
"""

from __future__ import annotations

from pulser_tpu_torch.backend.config import BackendConfig
from pulser_tpu_torch.backend.remote import (
    JobParams,
    RemoteBackend,
    RemoteConnection,
    RemoteResults,
)
from pulser_tpu_torch.sequence import Sequence


class QPUBackend(RemoteBackend):
    """Backend for sequence execution on a QPU.

    Args:
        sequence: A Sequence to execute on a backend accessible via a
            remote connection.
        connection: The remote connection through which the jobs are
            executed.
        config: An optional backend configuration. For a QPU, it can
            define a `default_num_shots`.
    """

    def __init__(
        self,
        sequence: Sequence,
        connection: RemoteConnection,
        *,
        config: BackendConfig | None = None,
    ) -> None:
        """Starts a new QPU backend instance."""
        super().__init__(
            sequence, connection, mimic_qpu=True, config=config
        )

    def run(
        self,
        job_params: list[JobParams] | None = None,
        wait: bool = False,
    ) -> RemoteResults:
        """Runs the sequence on the remote QPU.

        Args:
            job_params: A list of dictionaries with the parameters to
                execute each job. If not given, the backend attempts to
                run one job with 'BackendConfig.default_num_shots'.
                Each dictionary may carry a custom 'runs' count; when
                absent, 'default_num_shots' is used if available.
            wait: Whether to wait until the results of the jobs become
                available. If False, the call is non-blocking.

        Returns:
            The results, available once execution is done.
        """
        if self._config.default_num_shots is not None:
            if job_params is None:
                job_params = [
                    {"runs": self._config.default_num_shots}
                ]
            else:
                self._type_check_job_params(job_params)
                job_params = [
                    {"runs": self._config.default_num_shots} | d
                    for d in job_params
                ]
        # super().run() validates job_params since _mimic_qpu = True
        return super().run(job_params, wait)
