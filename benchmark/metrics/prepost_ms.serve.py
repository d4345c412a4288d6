"""Host ms a request spends outside the pipeline's device body: the host
clock of the call (`PipelineService.predict` or `GeoWizardPipeline.__call__`)
minus the synchronised host clock of `infer`, as a mean per request."""

from lib.readers import span_total_s

LAYER = "request entry"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "latency_p90_ms"


def read(rec):
    n = len(rec.get("spans", {}).get("infer", []))
    if not n:
        return None
    return 1e3 * (span_total_s(rec, "request") - span_total_s(rec, "infer")) / n
