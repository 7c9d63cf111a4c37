"""``backward_ms.train``, read the same way, in a training cell whose
end-to-end time is ``train_step_p90_ms`` alone (its rate is too unsteady
on the host to hold a bound there)."""

from pathlib import Path

from h100bench.harness import load_reader

read = load_reader(Path(__file__).with_name("backward_ms.train.py"))
