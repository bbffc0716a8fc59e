"""Expert parallelism: the serverless slot data plane (``ep``)."""
