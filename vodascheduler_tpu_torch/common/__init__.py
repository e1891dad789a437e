"""The port's own copies of the job contract the supervisor reads: the
spec file the backend writes and the preempted exit code it expects."""
